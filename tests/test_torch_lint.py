"""shardlint over the port (``llm_sharding_tpu_torch/analysis/``) against
the JAX package's rules (``llm_sharding_tpu/analysis/``).

Each ported rule runs beside the JAX rule on mirror fixtures of
``tests/test_analysis.py``'s lock-order, metrics and trace cases (each a
true positive or a near miss) and must give the same findings (rule,
relative path, message, key). Then the gate: ``lint`` over the port exits 0
with the committed empty baseline, its ``--json`` shape is JAX's, unknown
and jit-only rules exit 2, a partial ``--write-baseline`` keeps other
rules' fingerprints; and the clean result is not vacuous: three faults
planted in a copy of the port are each found. The two faults the port's
lint found when it first ran (a raw lock in the engine, the metric
children's unannotated family lock) keep their repairs.
"""

import io
import json
import os
import shutil
import subprocess
import sys

import pytest

from llm_sharding_tpu.analysis import core as jcore
from llm_sharding_tpu.analysis import rule_lockorder as jlock
from llm_sharding_tpu.analysis import rule_metrics as jmetrics
from llm_sharding_tpu.analysis import rule_trace as jtrace
from llm_sharding_tpu_torch.analysis import core as tcore
from llm_sharding_tpu_torch.analysis import lockorder as tlockorder
from llm_sharding_tpu_torch.analysis import rule_lockorder as tlock
from llm_sharding_tpu_torch.analysis import rule_metrics as tmetrics
from llm_sharding_tpu_torch.analysis import rule_trace as ttrace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "llm_sharding_tpu_torch")

LOCK_PRELUDE = '''
from llm_sharding_tpu_torch.analysis.lockorder import named_lock
'''

METRICS_README = """
| metric | type | meaning |
|---|---|---|
| `server_good_total{tenant,outcome}` | counter | documented + registered |
| `server_ghost_total` | counter | documented but never registered |
"""

TRACE_README = """
| span | emitted by | fields |
|---|---|---|
| `request` | server | fine |
| `phantom` | nobody | stale row |
"""

#: (rule, fixture source, README, expect findings?) mirroring
#: ``tests/test_analysis.py:172-330``
FIXTURES = {
    "lock_rank_violation": ("lock-order", LOCK_PRELUDE + '''
class Bad:
    def __init__(self):
        self._lock = named_lock("obs.metrics.family")
        self._mutex = named_lock("server.mutex")

    def run(self):
        with self._lock:
            with self._mutex:
                pass
''', "", True),
    "lock_near_miss": ("lock-order", LOCK_PRELUDE + '''
class Good:
    def __init__(self):
        self._lock = named_lock("obs.metrics.family")
        self._mutex = named_lock("server.mutex")

    def run(self):
        with self._mutex:
            with self._lock:
                pass
''', "", False),
    "lock_raw_threading": ("lock-order", '''
import threading

class Sneaky:
    def __init__(self):
        self._lock = threading.Lock()
''', "", True),
    "lock_cross_method_edge": ("lock-order", LOCK_PRELUDE + '''
class Router:
    def __init__(self):
        self._lock = named_lock("replica.router")

    def route(self):
        with self._lock:
            pass

class Server:
    def __init__(self):
        self._mutex = named_lock("server.mutex")
        self.router = Router()

    def step(self):
        with self._mutex:
            self.router.route()
''', "", True),
    "metrics_findings": ("metrics-discipline", '''
from .obs import REGISTRY

GOOD = REGISTRY.counter(
    "server_good_total", "fine", labels=("tenant", "outcome"),
)
NO_HELP = REGISTRY.counter("server_nohelp_total")

def feed(t):
    GOOD.labels(tenant=t, outcome="ok").inc()
    GOOD.labels(tenant=t, reason="oops").inc()
''', METRICS_README, True),
    "metrics_near_miss": ("metrics-discipline", '''
from .obs import REGISTRY

GOOD = REGISTRY.counter(
    "server_good_total", "fine", labels=("tenant", "outcome"),
)

def feed(t):
    GOOD.labels(tenant=t, outcome="ok").inc()
''', """
| metric | type | meaning |
|---|---|---|
| `server_good_total{tenant,outcome}` | counter | documented |
""", False),
    "trace_findings": ("trace-discipline", '''
def finish(writer, trace):
    emit_span(writer, "request", trace=trace)
    emit_span(writer, "mystery", trace=trace)
''', TRACE_README, True),
    "trace_near_miss": ("trace-discipline", '''
def finish(self, writer, trace):
    emit_span(writer, "request", trace=trace)
    self._span("phantom", x=1)
''', TRACE_README, False),
}

RULES = {
    "lock-order": (lambda pkg: jlock.check(pkg, scope=("fakepkg/mod.py",)),
                   lambda pkg: tlock.check(pkg, scope=("fakepkg/mod.py",))),
    "metrics-discipline": (jmetrics.check, tmetrics.check),
    "trace-discipline": (jtrace.check, ttrace.check),
}


def make_tree(tmp_path, files, readme=""):
    """A throwaway package ``fakepkg`` with ``files`` (package-relative
    paths → source) and README.md at the repo root; returns its root."""
    root = tmp_path / "fakepkg"
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
    (tmp_path / "README.md").write_text(readme)
    return str(root)


def view(findings):
    return sorted((f.rule, f.path, f.message, f.key) for f in findings)


@pytest.mark.parametrize("case", sorted(FIXTURES))
def test_ported_rule_gives_the_jax_findings(tmp_path, case):
    rule, src, readme, expect = FIXTURES[case]
    root = make_tree(tmp_path, {"mod.py": src}, readme)
    jcheck, tcheck = RULES[rule]
    want = view(jcheck(jcore.Package(root)))
    got = view(tcheck(tcore.Package(root)))
    assert got == want
    assert bool(got) == expect, got


def _lint(mod, **kw):
    out = io.StringIO()
    rc = mod.run_lint(out=out, **kw)
    return rc, out.getvalue()


def test_port_lint_clean_with_the_committed_empty_baseline():
    with open(tcore.default_baseline_path()) as f:
        assert json.load(f)["findings"] == []
    assert tcore.default_package_root() == PORT
    rc, out = _lint(tcore)
    assert rc == 0, out
    assert "0 new finding(s), 0 baselined" in out
    assert tcore.rule_names() == ["lock-order", "metrics-discipline", "trace-discipline"]


def test_cli_lint_exits_zero_without_torch():
    """``python -m llm_sharding_tpu_torch lint`` on the tree, torch and jax
    never imported."""
    code = (
        "import sys\n"
        "from llm_sharding_tpu_torch.cli import main\n"
        "rc = main(['lint'])\n"
        "bad = [m for m in sys.modules if m in ('torch', 'jax', 'llm_sharding_tpu')\n"
        "       or m.startswith(('torch.', 'jax.', 'llm_sharding_tpu.'))]\n"
        "assert not bad, bad\n"
        "sys.exit(rc)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    res = subprocess.run([sys.executable, "-m", "llm_sharding_tpu_torch", "lint"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "0 new finding(s)" in res.stdout, res.stdout + res.stderr


def test_json_shape_equals_jax(tmp_path):
    rule, src, readme, _ = FIXTURES["metrics_findings"]
    root = make_tree(tmp_path, {"mod.py": src}, readme)
    bl = str(tmp_path / "none.json")
    kw = dict(root=root, only=[rule], baseline_path=bl, as_json=True)
    jrc, jout = _lint(jcore, **kw)
    trc, tout = _lint(tcore, **kw)
    assert jrc == trc == 1
    assert json.loads(tout) == json.loads(jout)
    assert json.loads(tout)["new"] == len(json.loads(tout)["findings"]) > 0


@pytest.mark.parametrize("rules", [["no-such-rule"], ["dispatch-statics"], ["donation-safety"],
                                   ["lock-order", "donation-safety"]])
def test_unknown_and_jit_only_rules_exit_2(rules):
    rc, out = _lint(tcore, only=rules)
    assert rc == 2
    if set(rules) & {"dispatch-statics", "donation-safety"}:
        assert "not ported" in out and "specific to jit" in out
    else:
        assert "unknown rule" in out


def test_partial_write_baseline_keeps_other_rules(tmp_path):
    """``lint --rule X --write-baseline`` keeps the other rules' accepted
    fingerprints (``tests/test_analysis.py:369``'s case, on a trace fixture)."""
    rule, src, readme, _ = FIXTURES["trace_findings"]
    root = make_tree(tmp_path, {"mod.py": src}, readme)
    bl = tmp_path / "baseline.json"
    bl.write_text(json.dumps({"findings": ["lock-order:other.py:deadbeef0000"]}))
    rc, _ = _lint(tcore, root=root, baseline_path=str(bl), only=[rule], write_baseline=True)
    assert rc == 0
    fps = json.loads(bl.read_text())["findings"]
    assert "lock-order:other.py:deadbeef0000" in fps
    assert any(fp.startswith("trace-discipline:") for fp in fps)
    rc, _ = _lint(tcore, root=root, baseline_path=str(bl))
    assert rc == 0  # baselined, not fixed, but no NEW findings


def _port_copy(tmp_path):
    dst = tmp_path / "llm_sharding_tpu_torch"
    shutil.copytree(PORT, dst, ignore=shutil.ignore_patterns("__pycache__", "csrc"))
    shutil.copy(os.path.join(REPO, "README.md"), tmp_path / "README.md")
    return dst


def test_planted_faults_are_found(tmp_path):
    """The port's clean lint is not vacuous: a rank inversion, a metric
    without a README row and a span missing from the schema, each planted
    in a copy of the port, are each found."""
    dst = _port_copy(tmp_path)
    with open(dst / "runtime" / "faults.py", "a") as f:
        f.write('''

class _PlantedInversion:
    def __init__(self):
        self._inner = named_lock("obs.metrics.family")
        self._outer = named_lock("server.mutex")

    def run(self):
        with self._inner:
            with self._outer:
                pass
''')
    with open(dst / "obs" / "metrics.py", "a") as f:
        f.write('\nPLANTED = REGISTRY.counter("server_planted_total", "a planted metric")\n')
    with open(dst / "runtime" / "server.py", "a") as f:
        f.write('\n\ndef _planted(writer):\n    emit_span(writer, "planted_span")\n')
    rc, out = _lint(tcore, root=str(dst), baseline_path=str(tmp_path / "bl.json"))
    assert rc == 1
    assert "holding 'obs.metrics.family' (rank" in out and "'server.mutex'" in out
    assert "metric 'server_planted_total' is registered but has no row" in out
    assert "span 'planted_span' is emitted but missing" in out
    # the inversion is an edge against the order and closes a cycle with the
    # tree's own server.mutex -> obs.metrics.family edges
    assert "lock-acquisition cycle" in out and "5 new finding(s)" in out


def test_metrics_rule_names_the_jax_only_row():
    """The port registers every README metric but the jit one, which is
    named in ``NOT_PORTED`` (not baselined); the JAX rule over the port
    reports that row."""
    assert set(tmetrics.NOT_PORTED) == {"engine_jit_shape_keys_total"}
    pkg = tcore.Package(PORT)
    assert tmetrics.check(pkg) == []
    stale = [f for f in jmetrics.check(jcore.Package(PORT))]
    assert [f.key for f in stale] == ["stale:engine_jit_shape_keys_total"]
    regs = {r.name for r in tmetrics._collect_registrations(pkg)}
    readme = {n for n, _ in tmetrics._readme_tokens(pkg.readme)}
    assert regs == readme - set(tmetrics.NOT_PORTED)


def test_engine_lock_is_the_ranked_reconfig_lock(monkeypatch):
    """Repaired fault: ``Engine._lock`` was a raw ``threading.Lock`` outside
    the hierarchy (found by the port's lock-order rule); it is the JAX
    engine's ``engine.reconfig`` lock, tracked under the order checker, and
    the shared-server path holds it without a violation."""
    import torch

    from llm_sharding_tpu_torch.models import config, llama
    from llm_sharding_tpu_torch.runtime.engine import Engine

    was = tlockorder.enabled()
    tlockorder.enable(True)
    try:
        cfg = config.tiny_llama(num_hidden_layers=2)
        eng = Engine(cfg, llama.init_params(cfg, seed=0, dtype=torch.float32, device="cpu"),
                     devices=["cpu"])
        assert isinstance(eng._lock, tlockorder.TrackedLock)
        assert eng._lock.name == "engine.reconfig"
        srv = eng._shared_server(3, 4)
        assert eng._shared_server(5, 4) is srv
    finally:
        tlockorder.enable(was)


def test_metric_children_lock_is_annotated(tmp_path):
    """Repaired fault: the metric children's ``with self._lock`` could not
    be resolved by the lock-order rule until their lock carried its family
    name (``# shardlint: lock obs.metrics.family``, as in JAX); without the
    annotation the rule reports every such acquisition."""
    rel = "llm_sharding_tpu_torch/obs/metrics.py"
    assert tlock.check(tcore.Package(PORT), scope=(rel,)) == []
    dst = _port_copy(tmp_path)
    path = dst / "obs" / "metrics.py"
    text = path.read_text()
    assert text.count("  # shardlint: lock obs.metrics.family") == 3
    path.write_text(text.replace("  # shardlint: lock obs.metrics.family", ""))
    found = tlock.check(tcore.Package(str(dst)), scope=(rel,))
    assert found and all("cannot resolve" in f.message for f in found)


def test_analysis_imports_no_jax():
    code = (
        "import sys\n"
        "from llm_sharding_tpu_torch.analysis import core, rule_lockorder, rule_metrics, "
        "rule_trace, astutil\n"
        "core.rule_names()\n"
        "bad = [m for m in sys.modules if m in ('jax', 'torch', 'llm_sharding_tpu')\n"
        "       or m.startswith(('jax.', 'torch.', 'llm_sharding_tpu.'))]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
