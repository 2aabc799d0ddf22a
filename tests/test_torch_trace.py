"""The port's request tracing (``obs/trace.py``), its reports
(``obs/report.py``, the ``trace-report`` CLI) and the traced server against
the JAX package on the CPU.

A ``TraceContext`` JSON made by either package is read back by the other;
the writer rotates and the flight-recorder ring is bounded and can be
switched off (``tests/test_trace.py:71-127``). The port's ``report_json`` /
``render_report`` / ``trace_json`` over a trace file written by either
package equal the JAX functions' output exactly, and the two
``trace-report`` CLIs print the same bytes. The served cases run the
port's CPU server (``tiny_llama``, 2 layers, f32 weights from
``jax.random.key(3)``, block size 4, the radix cache on) beside the JAX
paged ``PipelineServer`` (one stage, ``paged_attn="xla"``) on the same
prompts: the greedy streams are identical to each other and to the port's
run without tracing, and each request gives one tree with no orphans that
holds the same span names as the JAX tree. ``snapshot`` / ``restore`` and
``extract`` / ``adopt`` keep each ``trace_id`` (``tests/test_trace.py:302``).
No module the port added for observability imports jax or the JAX package.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the JAX package is the reference
jnp = jax.numpy

from llm_sharding_tpu import cli as jcli
from llm_sharding_tpu.models import config as jcfg  # models first: ops <-> models cycle
from llm_sharding_tpu.models import llama as jllama
from llm_sharding_tpu.obs import report as jreport
from llm_sharding_tpu.obs import trace as jtrace
from llm_sharding_tpu.runtime.engine import PipelineEngine
from llm_sharding_tpu_torch import cli as tcli
from llm_sharding_tpu_torch.models import config as tcfg
from llm_sharding_tpu_torch.models import llama as tllama
from llm_sharding_tpu_torch.obs import report as treport
from llm_sharding_tpu_torch.obs import trace as ttrace
from llm_sharding_tpu_torch.obs.trace import (
    FLIGHT_RECORDER, SpanRing, TraceContext, TraceWriter, emit_span, valid_trace_id,
)
from llm_sharding_tpu_torch.runtime.engine import Engine
from llm_sharding_tpu_torch.runtime.server import (
    DECODE_SPAN_TOKENS, PipelineServer, load_snapshot, save_snapshot,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = tcfg.tiny_llama(num_hidden_layers=2)
KW = dict(capacity=64, kv_block_size=4, kv_blocks=80, prefix_cache="hbm")


# ------------------------------------------------------------ context units


@pytest.mark.parametrize("maker", ["jax", "port"])
def test_trace_context_json_read_back_by_the_other_package(maker):
    port, ref = TraceContext, jtrace.TraceContext
    make, read = (ref, port) if maker == "jax" else (port, ref)
    root = make.new(trace_id="my-trace_01")
    for ctx in (root, root.child()):
        back = read.from_json(json.loads(json.dumps(ctx.to_json())))
        assert (back.trace_id, back.span_id, back.parent_id) == (
            ctx.trace_id, ctx.span_id, ctx.parent_id)
    assert read.from_json(None) is None
    child = root.child()
    assert child.trace_id == root.trace_id and child.parent_id == root.span_id
    assert child.span_id != root.span_id
    evil = TraceContext.new(trace_id='bad"id\nwith spaces')
    assert valid_trace_id(evil.trace_id) and "\n" not in evil.trace_id
    for tid in ("ok-id", "", "x" * 129, "a b", None, 7):
        assert valid_trace_id(tid) == jtrace.valid_trace_id(tid)


def test_emit_span_event_equals_jax():
    ctx = TraceContext.new()
    for kw in (dict(trace=ctx), dict(parent_of=ctx), {}):
        got = emit_span(None, "request", dur_s=0.1234567891, src="s0", id=3, **kw)
        want = jtrace.emit_span(None, "request", dur_s=0.1234567891, src="s0", id=3, **kw)
        got.pop("ts"), want.pop("ts")
        assert got == want
    assert FLIGHT_RECORDER.snapshot()[-1]["span"] == "request"


def test_trace_writer_rotation_and_close(tmp_path):
    path = str(tmp_path / "t.jsonl")
    w = TraceWriter(path, max_bytes=2000)
    for i in range(200):
        w.emit("spam", i=i, pad="x" * 40)
    assert os.path.getsize(path) <= 2000 and os.path.getsize(path + ".1") <= 2000
    for p in (path, path + ".1"):
        with open(p) as f:
            for line in f:
                assert json.loads(line)["span"] == "spam"
    w.close()
    size = os.path.getsize(path)
    w.emit("after_close")
    w.close()
    assert os.path.getsize(path) == size


def test_span_ring_bounded_and_disable():
    ring = SpanRing(capacity=4)
    for i in range(10):
        ring.append({"span": "s", "i": i})
    snap = ring.snapshot()
    assert len(snap) == 4 and snap[0]["i"] == 6 and snap[-1]["i"] == 9
    assert ring.capacity == 4 and ring.enabled
    ring.set_enabled(False)
    ring.append({"span": "s", "i": 99})
    assert len(ring.snapshot()) == 4
    ring.set_enabled(True)
    ring.clear()
    assert ring.snapshot() == []


# ----------------------------------------------- reports over either file


def write_fake_traces(mod, tmp_path):
    ing, srv = str(tmp_path / "t.ingress"), str(tmp_path / "t.r0")
    root = mod.TraceContext.new(trace_id="traceA")
    reqctx = root.child()
    wi = mod.TraceWriter(ing)
    wi.emit("ingress", dur_s=2.0, trace_id=root.trace_id, span_id=root.span_id,
            tenant="alice", rid=0, outcome="ok", src="ingress")
    wi.emit("queue", dur_s=0.5, trace_id=root.trace_id, parent=root.span_id, tenant="alice",
            src="ingress")
    wi.close()
    ws = mod.TraceWriter(srv)
    ws.emit("request", dur_s=1.4, trace_id=reqctx.trace_id, span_id=reqctx.span_id,
            parent=reqctx.parent_id, id=5, tokens=8, ttft_s=0.6, tenant="alice", src="s0")
    ws.emit("prefill", dur_s=0.5, trace_id=reqctx.trace_id, parent=reqctx.span_id, id=5,
            bucket=8, src="s0")
    ws.emit("decode", dur_s=0.8, trace_id=reqctx.trace_id, parent=reqctx.span_id, id=5,
            tokens=8, src="s0")
    ws.emit("orphan", dur_s=0.1, trace_id=reqctx.trace_id, parent="gone", src="s0")
    ws.emit("chunk", dur_s=0.01, src="s0")
    ws.close()
    with open(srv, "a") as f:
        f.write('{"torn": ')  # a crashed writer's last line
    return [ing, srv]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_trace_reports_equal_jax_on_either_packages_file(writer, tmp_path):
    paths = write_fake_traces(jtrace if writer == "jax" else ttrace, tmp_path)
    ev_p, ev_j = treport.load_events(paths), jreport.load_events(paths)
    assert ev_p == ev_j and len(ev_p) == 7
    assert treport.report_json(ev_p, top=3) == jreport.report_json(ev_j, top=3)
    assert treport.render_report(ev_p) == jreport.render_report(ev_j)
    assert treport.render_report(ev_p, trace_id="traceA") == jreport.render_report(
        ev_j, trace_id="traceA")
    assert treport.trace_json(ev_p, "traceA") == jreport.trace_json(ev_j, "traceA")
    tr = treport.build_traces(ev_p)["traceA"]
    assert tr.root["span"] == "ingress" and len(tr.orphans()) == 1 and tr.tenant == "alice"


TRACE_ARGV = [[], ["--json"], ["--top", "1"], ["--trace", "traceA"],
              ["--json", "--trace", "traceA"], ["--json", "--trace", "nope"]]


@pytest.mark.parametrize("args", TRACE_ARGV, ids=lambda a: " ".join(a) or "plain")
def test_trace_report_cli_prints_what_jax_prints(args, tmp_path, capsys):
    paths = write_fake_traces(jtrace, tmp_path)
    rc = tcli.main(["trace-report", *args, *paths])
    port = capsys.readouterr().out
    assert rc == jcli.main(["trace-report", *args, *paths])
    assert port == capsys.readouterr().out
    assert rc == (1 if "nope" in args else 0)


def test_trace_report_cli_globs_and_missing_files(tmp_path, capsys):
    write_fake_traces(jtrace, tmp_path)
    assert tcli.main(["trace-report", str(tmp_path / "t.*")]) == 0
    assert "traceA" in capsys.readouterr().out
    assert tcli.main(["trace-report", str(tmp_path / "missing.jsonl")]) == 2
    (tmp_path / "empty.jsonl").write_text("\n")
    assert tcli.main(["trace-report", str(tmp_path / "empty.jsonl")]) == 1


# -------------------------------------------------------- served (CPU server)


@pytest.fixture(scope="module")
def setup():
    cj = jcfg.tiny_llama(num_hidden_layers=2)
    tree = jax.tree.map(np.asarray, jllama.init_params(cj, jax.random.key(3), dtype=jnp.float32))
    eng = Engine(CFG, tllama.params_from_numpy(CFG, tree, device="cpu"))
    jeng = PipelineEngine(cj, jax.tree.map(jnp.asarray, tree), num_stages=1,
                          cache_dtype=jnp.float32)
    return eng, jeng


PROMPTS = [np.random.default_rng(s).integers(3, CFG.vocab_size, n).astype(np.int32)
           for s, n in ((1, 5), (2, 7), (3, 6))]
MAX_NEW = DECODE_SPAN_TOKENS + 8  # one full decode bucket and a remainder


def span_names(path):
    """trace_id -> (span names, orphans, roots) of each tree in ``path``."""
    out = {}
    for tid, tr in treport.build_traces(treport.load_events([path])).items():
        roots = [e for e in tr.spans if e.get("parent") is None]
        out[tid] = (sorted(e["span"] for e in tr.spans), len(tr.orphans()), len(roots))
    return out


def test_served_streams_and_trees_match_jax(setup, tmp_path):
    eng, jeng = setup
    plain = eng.serve(**KW)
    base = [plain.submit(p, MAX_NEW) for p in PROMPTS]
    plain.run_until_idle()
    plain.close()

    path = str(tmp_path / "port.jsonl")
    srv = eng.serve(trace_path=path, **KW)
    reqs = [srv.submit(p, MAX_NEW) for p in PROMPTS]
    srv.stepline.arm(4)  # a deep capture armed: same streams
    srv.run_until_idle()
    srv.close()
    assert srv.stepline.capture_bundle()["complete"]
    jpath = str(tmp_path / "jax.jsonl")
    jsrv = jeng.serve(paged_attn="xla", trace_path=jpath, **KW)
    jreqs = [jsrv.submit(p, MAX_NEW) for p in PROMPTS]
    jsrv.run_until_idle()
    jsrv.close()

    assert [r.tokens for r in reqs] == [r.tokens for r in base] == [r.tokens for r in jreqs]
    port, ref = span_names(path), span_names(jpath)
    assert len(port) == len(reqs)
    for r, jr in zip(reqs, jreqs):
        names, orphans, roots = port[r.trace.trace_id]
        assert (orphans, roots) == (0, 1)
        assert names == ref[jr.trace.trace_id][0]
        assert {"request", "radix", "prefill", "decode"} <= set(names)
    # the loop spans carry no trace and name the step phases
    loop = {e["span"] for e in treport.load_events([path]) if "trace_id" not in e}
    assert {"admit", "chunk", "apply"} <= loop


def test_submit_trace_parents_the_request(setup, tmp_path):
    eng, _ = setup
    path = str(tmp_path / "t.jsonl")
    srv = eng.serve(trace_path=path, **KW)
    parent = TraceContext.new(trace_id="caller-trace")
    req = srv.submit(PROMPTS[0], 4, trace=parent)
    assert req.trace.trace_id == "caller-trace" and req.trace.parent_id == parent.span_id
    victim = srv.submit(PROMPTS[1], 4)
    srv.cancel(victim)
    srv.run_until_idle()
    srv.close()
    ev = treport.load_events([path])
    root = [e for e in ev if e["span"] == "request" and e["trace_id"] == "caller-trace"]
    assert root and root[0]["parent"] == parent.span_id
    assert [e["outcome"] for e in ev if e["span"] == "request"
            and e["trace_id"] == victim.trace.trace_id] == ["cancelled"]


def check_one_tree_each(paths, reqs):
    traces = treport.build_traces(treport.load_events(paths))
    for r in reqs:
        tr = traces[r.trace.trace_id]
        assert tr.orphans() == [] and tr.root["span"] == "request"
        assert tr.root["span_id"] == r.trace.span_id
        assert [e["span"] for e in tr.spans].count("request") == 1


def test_snapshot_restore_keeps_each_trace_id(setup, tmp_path):
    eng, _ = setup
    p1, p2 = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    srv = eng.serve(trace_path=p1, batch_per_slot=2, **KW)
    ra = srv.submit(PROMPTS[0], MAX_NEW)
    rb = srv.submit(PROMPTS[1], MAX_NEW, temperature=0.9, seed=3)
    rc = srv.submit(PROMPTS[2], 6)  # still queued at the snapshot
    for _ in range(3):
        srv.step()
    assert not ra.done and not rb.done and rc.row is None
    save_snapshot(srv.snapshot(), str(tmp_path / "snap"))
    before = {r.id: r.trace.to_json() for r in (ra, rb, rc)}
    srv.close()
    srv2 = PipelineServer.restore(eng, load_snapshot(str(tmp_path / "snap")))
    srv2._trace = TraceWriter(p2)
    revived = {r.id: r for r in list(srv2._req) + list(srv2._queue) if r is not None}
    assert {i: r.trace.to_json() for i, r in revived.items()} == before
    srv2.run_until_idle()
    srv2.close()
    # the first file's request spans failed (closed), the second's finished
    ev2 = treport.load_events([p2])
    done = {e["id"]: e for e in ev2 if e["span"] == "request"}
    for rid, ctx in before.items():
        assert [done[rid]["trace_id"], done[rid]["span_id"]] == ctx[:2]
        assert "outcome" not in done[rid]
    check_one_tree_each([p2], list(revived.values()))


def test_extract_adopt_keeps_each_trace_id(setup, tmp_path):
    eng, _ = setup
    p1, p2 = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    a = eng.serve(trace_path=p1, batch_per_slot=2, **KW)
    b = eng.serve(trace_path=p2, batch_per_slot=2, **KW)
    base = eng.serve(batch_per_slot=2, **KW)
    want = [base.submit(p, MAX_NEW) for p in PROMPTS[:2]]
    base.run_until_idle()
    base.close()
    reqs = [a.submit(p, MAX_NEW) for p in PROMPTS[:2]]
    for _ in range(4):
        a.step()
    assert not any(r.done for r in reqs)
    for r in reqs:
        st = a.extract(r)
        assert st.trace is r.trace
        b.adopt(st, r)
    b.run_until_idle()
    a.close()
    b.close()
    assert [r.tokens for r in reqs] == [r.tokens for r in want]
    check_one_tree_each([p1, p2], reqs)
    names = {e["span"] for e in treport.load_events([p1, p2]) if "trace_id" in e}
    assert {"extract", "adopt", "request", "prefill", "decode"} <= names


# ------------------------------------------------------------ no jax


NEW_MODULES = ["analysis/lockorder.py", "obs/trace.py", "obs/stepline.py", "obs/http.py",
               "obs/report.py", "obs/__init__.py", "cli.py", "runtime/server.py"]


def test_new_modules_import_no_jax():
    pkg = ROOT / "llm_sharding_tpu_torch"
    for rel in NEW_MODULES:
        for node in ast.walk(ast.parse((pkg / rel).read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "llm_sharding_tpu"), (rel, n)
    code = (
        "import sys\n"
        "import llm_sharding_tpu_torch.obs, llm_sharding_tpu_torch.obs.report\n"
        "import llm_sharding_tpu_torch.analysis.lockorder, llm_sharding_tpu_torch.cli\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
        "'llm_sharding_tpu', 'torch')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=120)
