"""The port's ``generate`` and ``serve`` commands against the JAX package's
on one JAX-written tiny store (f32, ``tests/test_cli.py``'s stand-in
tokenizer on both engines): stdout is equal, byte for byte, for
``generate`` (whole and ``--stream``) and for the stdin daemon (dense,
paged, speculative). The checks that need no model exit 2 with the JAX
messages; ``--stages`` / ``--ranges`` print what JAX's chain prints; a
flag of a later slice exits 2 before the model loads, naming its
``ROADMAP.md`` item; without ``--device cpu`` the commands want a GPU.
A ``--http-port`` daemon in a subprocess (a store without a tokenizer:
token-id prompts) answers as the in-process server streams, and SIGTERM
during a streamed request lets it finish and exits 0.
"""

import contextlib
import http.client
import io
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference
jnp = jax.numpy

from llm_sharding_tpu import cli as jcli
from llm_sharding_tpu.models import config as jcfg
from llm_sharding_tpu.models import llama as jllama
from llm_sharding_tpu.runtime import engine as jengine
from llm_sharding_tpu.utils import shard_store as jstore
from llm_sharding_tpu_torch import cli as tcli
from llm_sharding_tpu_torch.runtime import engine as tengine

# the tests' tensors are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = jcfg.tiny_llama(num_hidden_layers=2, vocab_size=64)


class IdTokenizer:
    """The stand-in for an HF tokenizer of ``tests/test_cli.py:23``."""

    def __call__(self, text):
        return {"input_ids": [ord(c) % 60 + 1 for c in text]}

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(int(i) % 26 + 97) for i in ids)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("cli") / "tiny_f32")
    jstore.save_shards(CFG, jllama.init_params(CFG, jax.random.key(0), dtype=jnp.float32), out)
    return out


@pytest.fixture
def tokenizers(monkeypatch):
    monkeypatch.setattr(jengine.PipelineEngine, "_require_tokenizer", lambda self: IdTokenizer())
    monkeypatch.setattr(tengine.Engine, "_require_tokenizer", lambda self: IdTokenizer())


def run(mod, argv, stdin=None):
    """(rc, stdout, stderr) of ``mod.main(argv)`` in this process."""
    out, err = io.StringIO(), io.StringIO()
    old = sys.stdin
    if stdin is not None:
        sys.stdin = io.StringIO(stdin)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = mod.main(argv)
    finally:
        sys.stdin = old
    return rc, out.getvalue(), err.getvalue()


def both(argv, stdin=None):
    """The JAX command (one stage) and the port's (on the CPU)."""
    j = run(jcli, argv + ["--stages", "1"], stdin)
    t = run(tcli, argv + ["--device", "cpu"], stdin)
    return j, t


@pytest.mark.parametrize("extra", [[], ["--stream"]], ids=["whole", "stream"])
def test_generate_stdout_equals_jax(store, tokenizers, extra):
    j, t = both(["generate", store, "--prompt", "hello world", "--max-new", "7",
                 "--dtype", "f32"] + extra)
    assert j[0] == t[0] == 0
    assert t[1] == j[1] and t[1].strip()


@pytest.mark.parametrize("extra", [[], ["--kv-block-size", "4", "--kv-blocks", "48"],
                                   ["--speculate", "2"], ["--prefill-chunk", "8"],
                                   ["--kv-block-size", "4", "--kv-blocks", "24", "--cp", "2",
                                    "--prefill-chunk", "8"]],
                         ids=["dense", "paged", "spec", "chunked", "cp2"])
def test_stdin_serve_stdout_equals_jax(store, tokenizers, extra):
    stdin = "hi there\n:counters\nsecond prompt, a longer one\n\n"
    j, t = both(["serve", store, "--max-new", "6", "--capacity", "64", "--dtype", "f32"]
                + extra, stdin)
    assert j[0] == t[0] == 0
    assert t[1] == j[1] and len(t[1].splitlines()) == 2
    assert '"requests_completed": 2' in t[2]


def test_control_lines_snapshot_restore_stats_profile(store, tokenizers, tmp_path):
    d = str(tmp_path / "snap")
    rc, out, err = run(tcli, ["serve", store, "--max-new", "4", "--capacity", "64", "--dtype",
                              "f32", "--device", "cpu"],
                       f"first prompt\n:stats\n:profile 0\n:snapshot {d}\n:placement 2\n:bogus\n")
    assert rc == 0 and len(out.splitlines()) == 1
    stats = json.loads(next(line for line in err.splitlines() if line.startswith('{"counters"')))
    assert {"counters", "metrics", "stepline"} <= set(stats)
    assert "server_ingress_requests_total" in stats["metrics"]
    assert f"snapshot written to {d}" in err and "unknown control line" in err
    # JAX's line (cli.py:344): the applied ranges over the one-axis mesh shape
    assert "placement applied: [(0, 1), (1, 2)] over OrderedDict({'pipe': 2})" in err
    rc, out2, err2 = run(tcli, ["serve", store, "--restore", d, "--max-new", "4", "--capacity",
                                "32", "--dtype", "f32", "--device", "cpu"], "first prompt\n")
    assert rc == 0 and "restored snapshot" in err2 and "--capacity 32 (snapshot: 64)" in err2
    assert out2 == out  # the same prompt, the same completion


FAST_FAIL = [
    ["--snapshot-every", "5"],
    ["--kv-block-size", "4"],
    ["--inflight-steps", "0"],
    ["--paged-attn", "kernel"],
    ["--kv-dtype", "int8"],
    ["--prefix-cache", "hbm"],
    ["--kv-block-size", "4", "--kv-blocks", "8", "--host-pool-blocks", "4"],
    ["--kv-block-size", "4", "--kv-blocks", "8", "--prefix-cache", "disk"],
    ["--disk-pool-blocks", "3"],
    ["--tenants-config", "{}"],
    ["--http-port", "1", "--tenants-config", '{"tenants": {"a": {"weight": 0}}}'],
    # the fleet's flags (JAX cli.py:554-640)
    ["--autoscale"],
    ["--disagg"],
    ["--data-parallel", "2", "--disagg"],
    ["--data-parallel", "2", "--disagg", "--kv-block-size", "4", "--kv-blocks", "8"],
    ["--prefill-replicas", "1"],
    ["--profile-json", "p.json"],
    ["--data-parallel", "2", "--disagg", "--kv-block-size", "4", "--kv-blocks", "8",
     "--prefix-cache", "hbm", "--prefill-replicas", "1", "--roles", "prefill,decode"],
    ["--data-parallel", "2", "--disagg", "--kv-block-size", "4", "--kv-blocks", "8",
     "--prefix-cache", "hbm", "--prefill-replicas", "2"],
    ["--data-parallel", "2", "--disagg", "--kv-block-size", "4", "--kv-blocks", "8",
     "--prefix-cache", "hbm", "--roles", "prefill,bogus"],
    ["--data-parallel", "3", "--disagg", "--kv-block-size", "4", "--kv-blocks", "8",
     "--prefix-cache", "host", "--roles", "prefill,decode"],
    ["--data-parallel", "2", "--disagg", "--kv-block-size", "4", "--kv-blocks", "8",
     "--prefix-cache", "hbm", "--profile-json", "/nonexistent/profile.json"],
]


@pytest.mark.parametrize("flags", FAST_FAIL, ids=lambda f: " ".join(f)[:40])
def test_fast_fail_exits_match_jax(flags):
    """Exit 2 and the JAX message, with no store to load (a missing path)."""
    argv = ["serve", "/nonexistent/store"] + flags
    j = run(jcli, argv)
    t = run(tcli, argv)
    assert j[0] == t[0] == 2
    assert t[2] == j[2] and t[2].startswith("error: ")


# flags a later slice of the port once refused, by the ROADMAP.md item that
# ported them: they now take the JAX checks (--cp without paged serving)
LATER = [(["--cp", "2"], "§A 16b")]


@pytest.mark.parametrize("flags,item", LATER, ids=lambda f: " ".join(f) if isinstance(f, list)
                         else f)
def test_later_slice_flags_exit_before_loading(flags, item):
    argv = ["serve", "/nonexistent/store"] + flags
    rc, out, err = run(tcli, argv)
    j = run(jcli, argv)
    assert rc == j[0] == 2 and err == j[2] and err.startswith("error: ") and not out


@pytest.fixture(scope="module")
def store4(tmp_path_factory):
    """A 4-layer store: room for a ragged 3-stage chain."""
    cfg = jcfg.tiny_llama(num_hidden_layers=4, vocab_size=64)
    out = str(tmp_path_factory.mktemp("cli4") / "tiny_f32")
    jstore.save_shards(cfg, jllama.init_params(cfg, jax.random.key(1), dtype=jnp.float32), out)
    return out


PIPE = [["--stages", "2"], ["--ranges", "0:1,1:3,3:4"]]


@pytest.mark.parametrize("cmd", ["generate", "serve"])
@pytest.mark.parametrize("flags", PIPE, ids=lambda f: " ".join(f))
def test_pipeline_flags_stdout_equals_jax(store4, tokenizers, flags, cmd):
    """``--stages 2`` and a ragged ``--ranges`` on both packages: the port's
    stages on the CPU (one --device runs every stage), the JAX chain over
    its CPU mesh; stdout equal byte for byte."""
    common = ["--max-new", "6", "--dtype", "f32"] + flags
    if cmd == "generate":
        argv, stdin = ["generate", store4, "--prompt", "hello world"] + common, None
    else:
        argv, stdin = ["serve", store4, "--capacity", "64"] + common, "hi there\nsecond one\n"
    j = run(jcli, argv, stdin)
    t = run(tcli, argv + ["--device", "cpu"], stdin)
    assert j[0] == t[0] == 0
    assert t[1] == j[1] and t[1].strip()
    if cmd == "serve":
        assert "stages from cpu" in t[2]


TP = [("generate", ["--tensor-parallel", "2"]),
      ("generate", ["--stages", "2", "--tensor-parallel", "2"]),
      ("serve", ["--tensor-parallel", "2"]),
      ("serve", ["--stages", "2", "--tensor-parallel", "2"]),
      ("serve", ["--data-parallel", "2", "--tensor-parallel", "2"])]


@pytest.mark.parametrize("cmd,flags", TP, ids=[f"{c} {' '.join(f)}" for c, f in TP])
def test_tensor_parallel_stdout_equals_jax(store4, tokenizers, cmd, flags):
    """``--tensor-parallel 2`` (with ``--stages 2``, and behind two
    replicas) on both packages: the port's shards on the CPU (one --device
    runs every stage and shard), the JAX megatron program over its CPU
    mesh; stdout equal byte for byte. The JAX ``generate`` parser has no
    tensor flags: its run there is the unsharded chain (the same tokens)."""
    common = ["--max-new", "6", "--dtype", "f32"]
    if cmd == "generate":
        argv = ["generate", store4, "--prompt", "hello world"] + common
        stdin = None
        # (JAX's chain defaults to one stage per device, more than 4 layers)
        jflags = flags[:2] if flags[0] == "--stages" else ["--stages", "1"]
    else:
        argv = ["serve", store4, "--capacity", "64"] + common
        stdin = "hi there\nsecond one\n"
        jflags = flags
    j = run(jcli, argv + jflags, stdin)
    t = run(tcli, argv + flags + ["--device", "cpu"], stdin)
    assert j[0] == t[0] == 0
    assert t[1] == j[1] and t[1].strip()
    if cmd == "serve" and "--data-parallel" not in flags:
        assert "2 tensor shards each from cpu" in t[2]


def test_commands_want_a_gpu_unless_told(store, tokenizers):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is available")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(tcli, ["generate", store, "--prompt", "x", "--max-new", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(tcli, ["serve", store], "")


def _post(port, body, stream=False):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/v1/completions", json.dumps({**body, "stream": stream}),
                 {"Content-Type": "application/json"})
    return conn, conn.getresponse()


def test_http_daemon_round_trip_and_sigterm_drain(store):
    """The daemon as users start it (a subprocess, a tokenizer-less store):
    token-id completions, whole and streamed, equal the in-process dense
    server's; SIGTERM while a stream is live: the stream completes, the
    daemon exits 0 and says it drained."""
    from llm_sharding_tpu_torch.runtime.engine import Engine

    p = [int(x) for x in np.random.default_rng(3).integers(3, 60, 6)]
    eng = Engine.from_shards(store, dtype=torch.float32, device="cpu")
    srv = eng.serve(capacity=128)
    want = srv.result(srv.submit(np.asarray(p, np.int32), 40))
    srv.close()
    with socket.socket() as sock:  # a free port
        sock.bind(("127.0.0.1", 0))
        free = sock.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "llm_sharding_tpu_torch", "serve", store, "--device", "cpu",
         "--dtype", "f32", "--capacity", "128", "--http-port", str(free)],
        cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
    )
    try:
        port = None
        lines = []
        while port is None:
            line = proc.stderr.readline()
            assert line, "".join(lines)
            lines.append(line)
            if line.startswith("ingress: http://127.0.0.1:"):
                port = int(line.split("127.0.0.1:")[1].split("/")[0])
        conn, resp = _post(port, {"prompt": p, "max_tokens": 40})
        body = json.loads(resp.read())
        conn.close()
        assert body["choices"][0]["token_ids"] == want
        conn, resp = _post(port, {"prompt": p, "max_tokens": 40}, stream=True)
        first = resp.readline()
        assert first.startswith(b"data: ")
        proc.send_signal(signal.SIGTERM)
        rest = resp.read().decode()
        conn.close()
        events = [json.loads(first[6:])] + [json.loads(x[6:]) for x in rest.splitlines()
                                            if x.startswith("data: {")]
        assert [t for e in events for t in e["choices"][0]["token_ids"]] == want
        assert rest.rstrip().endswith("data: [DONE]")
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err[-2000:]
        assert "drained; exiting 0" in err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _sse_tokens(resp) -> list:
    """The token ids of an SSE completion read to ``[DONE]``."""
    assert resp.status == 200
    out = []
    for line in resp.read().decode().splitlines():
        if line.startswith("data: {"):
            out += json.loads(line[6:])["choices"][0]["token_ids"]
    return out


def test_http_daemon_placement_mid_stream(store4):
    """``:placement 4`` on stdin while streams are live on a ``--stages 2``
    HTTP daemon (two rows): the ingress pauses, the old server runs the
    requests it holds to the end, and the rebuilt 4-stage server takes
    those still in the fair queue, sent after the line. Every stream
    answers 200 and equals the one-stage server's; at least one was still
    open when the line was sent."""
    import threading

    from llm_sharding_tpu_torch.runtime.engine import Engine

    rng = np.random.default_rng(5)
    prompts = [[int(x) for x in rng.integers(3, 60, n)] for n in (5, 9, 7, 4, 6)]
    n_new = 100
    eng = Engine.from_shards(store4, dtype=torch.float32, device="cpu")
    srv = eng.serve(capacity=128)
    want = [srv.result(srv.submit(np.asarray(p, np.int32), n_new)) for p in prompts]
    srv.close()
    with socket.socket() as sock:  # a free port
        sock.bind(("127.0.0.1", 0))
        free = sock.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "llm_sharding_tpu_torch", "serve", store4, "--device", "cpu",
         "--dtype", "f32", "--capacity", "128", "--stages", "2", "--http-port", str(free)],
        cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
    )
    lines: list = []
    reader = threading.Thread(target=lambda: lines.extend(iter(proc.stderr.readline, "")),
                              daemon=True)
    try:
        while not any(x.startswith("ingress: http://") for x in lines):
            assert proc.poll() is None, "".join(lines)
            line = proc.stderr.readline()
            lines.append(line)
        port = int(lines[-1].split("127.0.0.1:")[1].split("/")[0])
        reader.start()
        body = lambda p: {"prompt": p, "max_tokens": n_new}  # noqa: E731
        live = [_post(port, body(p), stream=True) for p in prompts[:3]]
        first = [resp.readline() for _, resp in live]  # the first two rows are streaming
        assert all(f.startswith(b"data: {") for f in first)
        proc.stdin.write(":placement 4\n")
        proc.stdin.flush()
        sent = time.perf_counter()
        late = [_post(port, body(p), stream=True) for p in prompts[3:]]
        got, done_at = [], []
        for (conn, resp), f in zip(live + late, first + [b""] * len(late)):
            toks = json.loads(f[6:])["choices"][0]["token_ids"] if f else []
            got.append(toks + _sse_tokens(resp))
            done_at.append(time.perf_counter())
            conn.close()
        assert got == want
        assert any(t > sent for t in done_at[:3])
        deadline = time.perf_counter() + 60
        while not any("placement applied" in x for x in lines):
            assert time.perf_counter() < deadline, "".join(lines)
            time.sleep(0.05)
        assert ("placement applied: [(0, 1), (1, 2), (2, 3), (3, 4)] over "
                "OrderedDict({'pipe': 4})") in "".join(lines)
        proc.stdin.close()
        proc.wait(timeout=60)
        reader.join(timeout=10)
        assert proc.returncode == 0, "".join(lines[-20:])
        assert '"requests_completed": 5' in "".join(lines)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_dp_daemon_drain_spawn_stdout_equals_jax(store, tokenizers):
    """``serve --data-parallel 2`` on the CPU: the prompts' completions
    equal the JAX dp daemon's, byte for byte, through ``:drain 1`` and
    ``:spawn`` (the control lines answer as JAX's), and ``:stats`` carries
    the per-replica view."""
    stdin = ("hi there\n:drain 1\nsecond prompt, a longer one\n:drain 0\n:spawn\n:spawn\n"
             ":stats\nthird\n:bogus\n")
    j, t = both(["serve", store, "--max-new", "6", "--capacity", "64", "--dtype", "f32",
                 "--data-parallel", "2", "--kv-block-size", "4", "--kv-blocks", "48"], stdin)
    assert j[0] == t[0] == 0
    assert t[1] == j[1] and len(t[1].splitlines()) == 3
    for line in ("replica 1 drained: 0 request(s) migrated; 1 replica(s) live",
                 "drain failed: drain refused: 0 replica(s) would remain, below min_replicas=1",
                 "replica spawned on group 1; 2 replica(s) live",
                 "spawn failed: no freed device group to spawn on",
                 "unknown control line ':bogus' (dp daemon"):
        assert line in t[2] and line in j[2]
    stats = json.loads(next(x for x in t[2].splitlines() if x.startswith('{"counters"')))
    assert [r["replica"] for r in stats["replicas"]] == [0, 1] and "metrics" in stats
    assert stats["offline_groups"] == []


def test_dp_daemon_restore_refused_like_jax():
    argv = ["serve", "/nonexistent/store", "--data-parallel", "2", "--restore", "/x"]
    j = run(jcli, argv)
    t = run(tcli, argv)
    assert j[0] == t[0] == 2 and t[2] == j[2] and "restore_into" in t[2]
