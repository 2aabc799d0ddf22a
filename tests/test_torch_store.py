"""Shard stores cross between the packages byte for byte, and the port
stays independent of JAX and of the JAX package.

A store written by the JAX package loads in the port into identical
tensors (bf16 and f32), and the reverse; a quantized store is refused with
``NotPorted``. A subprocess imports every port module (and
``chip_smoke.py``) and finds neither ``jax`` nor ``llm_sharding_tpu`` in
``sys.modules``; an AST scan finds no such import in their sources.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from llm_sharding_tpu_torch.device import NotPorted
from llm_sharding_tpu_torch.models import config as tcfg
from llm_sharding_tpu_torch.models import llama as tllama
from llm_sharding_tpu_torch.utils import shard_store as tstore
from llm_sharding_tpu_torch.utils.shard_store import tensor_from_numpy

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "llm_sharding_tpu_torch"
DTYPES = ["bfloat16", "float32"]


@pytest.fixture
def jx():
    """The JAX package's side of a crossing test; skipped without JAX (the
    isolation tests below need no JAX)."""
    jax = pytest.importorskip("jax")
    from llm_sharding_tpu.models import config, llama
    from llm_sharding_tpu.ops.quant import quantize_layer_params
    from llm_sharding_tpu.utils import shard_store

    return SimpleNamespace(jax=jax, jnp=jax.numpy, cfg=config, llama=llama, store=shard_store,
                           quantize=quantize_layer_params)


def _same(t: torch.Tensor, a) -> None:
    want = tensor_from_numpy(np.asarray(a))
    assert t.dtype == want.dtype and tuple(t.shape) == tuple(want.shape)
    assert torch.equal(t.view(torch.int16) if t.dtype == torch.bfloat16 else t,
                       want.view(torch.int16) if want.dtype == torch.bfloat16 else want)


@pytest.mark.parametrize("dt", DTYPES)
def test_jax_store_loads_in_port(tmp_path, dt, jx):
    cfg = jx.cfg.tiny_qwen2(num_hidden_layers=2)
    params = jx.llama.init_params(cfg, jx.jax.random.key(0), dtype=getattr(jx.jnp, dt))
    jx.store.save_shards(cfg, params, str(tmp_path))
    ct, got = tstore.load_full(str(tmp_path), dtype=None, device="cpu")
    assert ct == tcfg.tiny_qwen2(num_hidden_layers=2)
    _same(got["embed"], params["embed"])
    _same(got["final_norm"], params["final_norm"])
    for i in range(2):
        assert set(got["layers"][i]) == set(params["layers"])
        for k, v in params["layers"].items():
            _same(got["layers"][i][k], v[i])


@pytest.mark.parametrize("dt", DTYPES)
def test_port_store_loads_in_jax(tmp_path, dt, jx):
    cfg = tcfg.tiny_llama(num_hidden_layers=2, tie_word_embeddings=False)
    params = tllama.init_params(cfg, seed=1, dtype=getattr(torch, dt), device="cpu")
    tstore.save_shards(cfg, params, str(tmp_path))
    cj, got = jx.store.load_full(str(tmp_path), dtype=getattr(jx.jnp, dt))
    assert cj == jx.cfg.tiny_llama(num_hidden_layers=2, tie_word_embeddings=False)
    for k in ("embed", "final_norm", "lm_head"):
        _same(params[k], got[k])
    for i in range(2):
        for k, v in got["layers"].items():
            _same(params["layers"][i][k], v[i])


def test_quantized_store_is_refused(tmp_path, jx):
    cfg = jx.cfg.tiny_llama(num_hidden_layers=1)
    params = jx.llama.init_params(cfg, jx.jax.random.key(0))
    params["layers"] = jx.quantize(params["layers"])
    jx.store.save_shards(cfg, params, str(tmp_path))
    with pytest.raises(NotPorted, match="quantized"):
        tstore.load_full(str(tmp_path), device="cpu")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import llm_sharding_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'llm_sharding_tpu')]\n"
        "assert len(mods) >= 20, mods\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_jax_imports_in_port_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 20
    for f in files:
        bad = _imported_roots(f) & {"jax", "jaxlib", "llm_sharding_tpu"}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"
