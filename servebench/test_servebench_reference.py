"""The frozen reference agrees with the port at a tiny qwen2 size with
non-zero q/k/v biases, in f32 (the port's dense forward; the test may
import the port, the reference never does)."""

import numpy as np
import pytest
import torch

from servebench import weights
from servebench.reference import qwen2

from .conftest import TINY_CFG


@pytest.mark.parametrize("kv_heads", [1, 2])
def test_reference_matches_the_port(kv_heads):
    from llm_sharding_tpu_torch.models import llama
    from llm_sharding_tpu_torch.models.cache import init_cache
    from llm_sharding_tpu_torch.models.config import ModelConfig

    cfg = dict(TINY_CFG, num_key_value_heads=kv_heads)
    d = weights.Dims.of(cfg)
    seed = 2**35 + 3
    cpu = torch.device("cpu")
    raw = weights.make_params(d, seed, cpu)
    assert float(raw["layers"][0]["bk"].abs().max()) > 0.1  # the biases are live
    params = {k: (v.float() if torch.is_tensor(v) else [{n: t.float() for n, t in p.items()}
                                                          for p in v]) for k, v in raw.items()}
    mcfg = ModelConfig.from_hf_config(cfg)
    ids = np.random.default_rng(0).integers(0, 500, 37)
    cache = init_cache(mcfg, 1, 64, dtype=torch.float32, device=cpu)
    pos = torch.arange(37, dtype=torch.int32)[None]
    with torch.no_grad():
        port, _ = llama.forward(mcfg, params, torch.as_tensor(ids)[None], cache, pos)
    got = {}
    qwen2.run(d, seed, [ids], [np.arange(37)], lambda j, blk, lg: got.update(
        {int(p): lg[i] for i, p in enumerate(blk)}), cpu)
    ref = torch.stack([got[i] for i in range(37)])
    assert torch.allclose(ref, port[0].float(), atol=2e-4, rtol=1e-4), (ref - port[0]).abs().max()
    # the control differs from it: every matrix rounded to float8
    ctl = {}
    qwen2.run(d, seed, [ids], [np.arange(37)], lambda j, blk, lg: ctl.update(
        {int(p): lg[i] for i, p in enumerate(blk)}), cpu, quant="fp8")
    assert (torch.stack([ctl[i] for i in range(37)]) - ref).abs().max() > 1e-2


def test_weights_redraw_bit_for_bit():
    d = weights.Dims.of(TINY_CFG)
    a = weights.make_layer(d, 5, 1, torch.device("cpu"))
    b = weights.make_layer(d, 5, 1, torch.device("cpu"))
    c = weights.make_layer(d, 6, 1, torch.device("cpu"))
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["wq"], c["wq"])
