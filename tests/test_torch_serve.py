"""The port's paged continuous-batching server against the JAX package's
``generate`` on ``tiny_llama`` in float32: staggered submits, one-shot
admission (flash path) and chunked admission (``prefill_chunk=8``, the
chunked-prefill path) must all stream exactly the oracle's greedy tokens
and leave the block allocator drained. Block exhaustion is a queue wait;
a request that can never fit is a typed rejection at submit.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference
jnp = jax.numpy

from llm_sharding_tpu.models import config as jcfg
from llm_sharding_tpu.models import llama as jllama
from llm_sharding_tpu.runtime.generate import generate as jgenerate
from llm_sharding_tpu_torch.device import NotPorted
from llm_sharding_tpu_torch.models import config as tcfg
from llm_sharding_tpu_torch.models import llama as tllama
from llm_sharding_tpu_torch.runtime.engine import Engine
from llm_sharding_tpu_torch.runtime.generate import generate as tgenerate
from llm_sharding_tpu_torch.runtime.server import NeverFits, RequestFailed

LENS = (5, 20, 9, 30, 3)
MAX_NEW = (10, 12, 8, 8, 9)


@pytest.fixture(scope="module")
def setup():
    cj, ct = jcfg.tiny_llama(), tcfg.tiny_llama()
    tree = jax.tree.map(np.asarray, jllama.init_params(cj, jax.random.key(0), dtype=jnp.float32))
    eng = Engine(ct, tllama.params_from_numpy(ct, tree, device="cpu"))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in LENS]
    pj = jax.tree.map(jnp.asarray, tree)
    oracle = []
    for p, m in zip(prompts, MAX_NEW):
        r = jgenerate(cj, pj, p, m, cache_dtype=jnp.float32)
        oracle.append(np.asarray(r.tokens)[0, len(p) : int(r.lengths[0])].tolist())
    return eng, prompts, oracle


def _drained(srv):
    srv._alloc.check()
    assert srv._alloc.in_use == 0


@pytest.mark.parametrize("prefill_chunk", [None, 8], ids=["one_shot", "chunked"])
def test_staggered_streams_match_jax_generate(setup, prefill_chunk):
    """Two requests first, three more joining mid-decode."""
    eng, prompts, oracle = setup
    srv = eng.serve(capacity=64, batch_per_slot=3, kv_block_size=4, kv_blocks=40,
                    prefill_chunk=prefill_chunk)
    reqs = [srv.submit(prompts[i], MAX_NEW[i]) for i in (0, 1)]
    srv.step()
    srv.step()
    reqs += [srv.submit(prompts[i], MAX_NEW[i]) for i in (2, 3, 4)]
    srv.run_until_idle()
    for r, want in zip(reqs, oracle):
        assert r.done and r.tokens == want
    _drained(srv)


def test_stream_and_result(setup):
    eng, prompts, oracle = setup
    srv = eng.serve(capacity=64, batch_per_slot=2, kv_block_size=8, kv_blocks=12,
                    prefill_chunk=8)
    a = srv.submit(prompts[3], MAX_NEW[3])
    b = srv.submit(prompts[1], MAX_NEW[1])
    assert list(srv.stream(a)) == oracle[3]
    assert srv.result(b) == oracle[1]
    _drained(srv)


def test_block_exhaustion_is_a_queue_wait(setup):
    """A pool that holds one request at a time: the rest wait in FIFO order
    and still stream the oracle's tokens."""
    eng, prompts, oracle = setup
    srv = eng.serve(capacity=64, batch_per_slot=3, kv_block_size=4, kv_blocks=12)
    reqs = [srv.submit(prompts[i], MAX_NEW[i]) for i in (1, 3, 0)]
    srv.step()
    assert len(srv._queue) >= 1
    srv.run_until_idle()
    for r, i in zip(reqs, (1, 3, 0)):
        assert r.tokens == oracle[i]
    _drained(srv)


def test_never_fitting_request_is_rejected(setup):
    eng, prompts, _ = setup
    srv = eng.serve(capacity=64, batch_per_slot=2, kv_block_size=4, kv_blocks=6)
    with pytest.raises(NeverFits, match="KV blocks"):
        srv.submit(prompts[1], 20)  # bucket 32 + 20 -> 13 blocks of a 5-block pool
    with pytest.raises(NeverFits, match="capacity"):
        srv.submit(prompts[3], 40)  # bucket 32 + 40 > 64
    assert not srv._queue


def test_cancel_releases_blocks(setup):
    eng, prompts, oracle = setup
    srv = eng.serve(capacity=64, batch_per_slot=2, kv_block_size=4, kv_blocks=40)
    a = srv.submit(prompts[1], MAX_NEW[1])
    b = srv.submit(prompts[0], MAX_NEW[0])
    srv.step()
    assert srv.cancel(a)
    assert srv._alloc.in_use > 0
    srv.run_until_idle()
    assert b.tokens == oracle[0]
    _drained(srv)


def test_close_fails_live_requests(setup):
    eng, prompts, _ = setup
    srv = eng.serve(capacity=64, batch_per_slot=1, kv_block_size=4, kv_blocks=40)
    a = srv.submit(prompts[0], MAX_NEW[0])
    b = srv.submit(prompts[2], MAX_NEW[2])
    srv.step()
    srv.close()
    for r in (a, b):
        with pytest.raises(RequestFailed):
            srv.result(r)
    _drained(srv)


def test_sampled_row_matches_port_generate(setup):
    """A sampled request draws from its own seeded generator, so it streams
    exactly what the port's generate draws at batch 1."""
    eng, prompts, _ = setup
    srv = eng.serve(capacity=64, batch_per_slot=2, kv_block_size=4, kv_blocks=40,
                    prefill_chunk=8)
    kw = dict(temperature=0.9, top_k=20, top_p=0.95, seed=5)
    reqs = [srv.submit(prompts[i], 10, **kw) for i in (0, 3)]
    srv.run_until_idle()
    for r, i in zip(reqs, (0, 3)):
        want = tgenerate(eng.cfg, eng.params, prompts[i], 10, **kw)
        assert r.tokens == want.tokens[0, LENS[i] : want.lengths[0]].tolist()


def test_block_allocator_matches_jax():
    """The port's own allocator copy hands out the same block ids as the
    JAX one over the same alloc/free sequence, and refuses the same
    misuse."""
    from llm_sharding_tpu.runtime import blocks as jblocks
    from llm_sharding_tpu_torch.runtime import blocks as tblocks

    ja, ta = jblocks.BlockAllocator(9, 4), tblocks.BlockAllocator(9, 4)
    for a in (ja, ta):
        x = a.alloc(3)
        y = a.alloc(2)
        a.free(x)
        z = a.alloc(4)
        a.check()
    assert (ta.num_free, ta.in_use, ta.capacity_blocks) == (ja.num_free, ja.in_use, 8)
    assert ta._free == ja._free and 0 not in y + z
    with pytest.raises(tblocks.BlockExhausted):
        ta.alloc(3)
    assert ta.num_free == 2  # no partial allocation
    with pytest.raises(ValueError, match="trash"):
        ta.free([0])
    ta.free(y)
    with pytest.raises(ValueError, match="double free"):
        ta.free(y[:1])
    ta.free(z)
    ta.check()
    assert ta.in_use == 0


def test_serve_needs_paged_kv(setup):
    eng = setup[0]
    with pytest.raises(NotPorted, match="dense serving"):
        eng.serve(capacity=64)
    with pytest.raises(ValueError, match="go together"):
        eng.serve(capacity=64, kv_block_size=4)


def test_engine_from_shards_serves(setup, tmp_path):
    eng, prompts, oracle = setup
    from llm_sharding_tpu_torch.utils.shard_store import save_shards

    save_shards(eng.cfg, eng.params, str(tmp_path))
    eng2 = Engine.from_shards(str(tmp_path), dtype=torch.float32, device="cpu")
    srv = eng2.serve(capacity=64, batch_per_slot=1, kv_block_size=8, kv_blocks=10)
    assert srv.result(srv.submit(prompts[2], MAX_NEW[2])) == oracle[2]
    res = eng2.generate_ids(prompts[2], MAX_NEW[2])
    assert res.tokens[0, LENS[2] : res.lengths[0]].tolist() == oracle[2]
