"""The port's multi-process ring (``parallel/distributed.py``, the
``worker`` / ``launch`` commands): ``launch --platform cpu`` spawns the
ranks, which join a ``gloo`` group, load their stage's layers only and
pass the hidden state around; rank 0's completion equals the port's
one-process ``generate`` command, exactly (a store without a tokenizer:
``--prompt-ids`` in, the generated ids out). The store is the JAX
package's, written from a seeded tree (tiny_llama, 4 layers, f32).
"""

import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the JAX package writes the store
jnp = jax.numpy

from llm_sharding_tpu.models import config as jcfg  # models first: ops <-> models cycle
from llm_sharding_tpu.models import llama as jllama
from llm_sharding_tpu.utils import shard_store as jstore


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    cfg = jcfg.tiny_llama(num_hidden_layers=4, vocab_size=64)
    out = str(tmp_path_factory.mktemp("ring") / "tiny_f32")
    jstore.save_shards(cfg, jllama.init_params(cfg, jax.random.key(1), dtype=jnp.float32), out)
    return out


def cli(*argv, timeout=240):
    p = subprocess.run([sys.executable, "-m", "llm_sharding_tpu_torch", *argv],
                       capture_output=True, text=True, timeout=timeout)
    return p.returncode, p.stdout, p.stderr


# (ranks, extra launch flags, prompt ids, max new): two balanced ranks, and
# three ragged ranks over a prompt that stops early at the stop id
CASES = {
    "2-balanced": (2, [], "5,6,7,8,9,10", 12),
    "3-ragged-stop": (3, ["--ranges", "0:1,1:3,3:4"], "11,12,13,14,15,16,17,18", 20),
}


@pytest.mark.parametrize("case", list(CASES))
def test_launch_prints_the_one_process_generate(store, tmp_path, case):
    ranks, flags, ids, n = CASES[case]
    rc, want, err = cli("generate", store, "--prompt-ids", ids, "--max-new", str(n),
                        "--device", "cpu", "--dtype", "f32")
    assert rc == 0, err
    logs = tmp_path / "logs"
    rc, got, err = cli("launch", store, "--processes", str(ranks), "--prompt-ids", ids,
                       "--max-new", str(n), "--dtype", "f32", "--platform", "cpu",
                       "--log-dir", str(logs), *flags)
    assert rc == 0, err
    assert got == want and got.strip()
    for i in range(ranks):
        log = (logs / f"worker_{i}.log").read_text()
        assert f"[worker {i}] joined: {ranks} processes over gloo" in log
    if case == "3-ragged-stop":  # the completion ended at the stop id
        assert got.split()[-1] == "2" and len(got.split()) < n


def test_worker_refuses_cp_in_the_jax_words(store):
    rc, out, err = cli("worker", store, "--coordinator", "localhost:1", "--processes", "2",
                       "--process-id", "0", "--prompt-ids", "1,2", "--cp", "2",
                       "--device", "cpu")
    assert rc == 2 and not out
    assert "cp > 1 on a multi-controller mesh: the per-shard block-table push is " \
           "single-controller for now" in err


def test_one_rank_group_helpers(tmp_path):
    """``initialize_multihost`` with an explicit backend, ``put_global`` and
    ``process_local_batch`` in a one-rank group (a subprocess: the group is
    process-global)."""
    code = f"""
import socket, numpy as np
from llm_sharding_tpu_torch.parallel import distributed as d
s = socket.socket(); s.bind(("localhost", 0)); port = s.getsockname()[1]; s.close()
try:
    d.initialize_multihost(f"localhost:{{port}}", 1, 0, backend="nccl")
except ValueError as e:
    print("refused", e)
d.initialize_multihost(f"localhost:{{port}}", 1, 0, backend="gloo")
a = np.arange(12).reshape(4, 3)
print(d.process_local_batch(8), d.put_global(a, "cpu", axis=0).numpy().tolist())
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    lines = p.stdout.splitlines()
    assert lines[0] == "refused backend must be one of ('gloo',), got 'nccl'"
    assert lines[1] == f"8 {np.arange(12).reshape(4, 3).tolist()}"


def test_launch_runs_on_the_card_unless_asked():
    """``launch`` and ``worker`` default to the card, as every port entry
    point does; ``--platform cpu`` is the opt-in the tests above pass."""
    from llm_sharding_tpu_torch.cli import build_parser

    la = build_parser().parse_args(["launch", "STORE", "--prompt-ids", "1,2"])
    assert (la.platform, la.device) == ("inherit", "cuda")
    w = build_parser().parse_args(["worker", "STORE", "--coordinator", "localhost:1",
                                   "--processes", "2", "--process-id", "0",
                                   "--prompt-ids", "1,2"])
    assert w.device == "cuda" and not hasattr(w, "backend")
