"""The metric readers: found by name, rates over the whole window, tails
over every request; and BENCHMARK.json in the contract's shape."""

import json
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from servebench import spec, stats
from servebench.driver import Rec
from servebench.run import Run
from servebench.trace import Trace, host_label, union
from servebench.weights import Dims

ROOT = Path(__file__).resolve().parents[1]
BENCH = spec.load_benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
D = Dims(H=8, I=16, L=2, Nh=4, Nkv=2, D=2, V=32, eps=1e-6, theta=1e6, bias=True, tied=False)


def fake_rec(plen, tokens, due, started, first, finished, open_tokens=0, close_tokens=None):
    req = types.SimpleNamespace(
        started_at=started, first_token_at=first, finished_at=finished,
        tokens=list(range(tokens)), done=finished is not None, error=None,
    )
    spec_ = types.SimpleNamespace(prompt=np.zeros(plen, np.int32))
    rec = Rec(spec_, req, due, due)
    rec.marks = {"open": open_tokens, "close": tokens if close_tokens is None else close_tokens}
    return rec


def fake_run(recs, **kw):
    base = dict(dims=D, server={"prefill_chunk": 16}, mix={}, recs=recs, t_open=10.0,
                t_close=20.0, window_s=10.0, setup_s=3.0, counters_open={"chunks": 5,
                "tokens_generated": 50}, counters_close={"chunks": 105, "tokens_generated": 4050},
                stepline=[])
    base.update(kw)
    return Run(**base)


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader(kind):
    for m in BENCH[kind]:
        assert callable(spec.reader(kind, m["name"]))


def test_dotted_names_fall_back_to_their_prefix():
    assert spec.reader("per_layer", "mfu.tok_s").__module__ == spec.reader(
        "per_layer", "mfu.ttft").__module__
    with pytest.raises(FileNotFoundError):
        spec.reader("per_layer", "no_such_metric.tok_s")


def test_rate_is_over_the_whole_window():
    recs = [fake_rec(8, 30, 0.0, 1.0, 2.0, None, open_tokens=10) for _ in range(4)]
    recs.append(fake_rec(8, 5, 15.0, 15.0, 15.5, 19.0))  # sent inside the window
    run = fake_run(recs)
    assert spec.reader("end_to_end", "output_tok_s")(run, "output_tok_s") == (4 * 20 + 5) / 10.0


def test_tails_take_every_request_in_the_window():
    recs = [fake_rec(8, 11, 10.0 + i * 0.05, 10.0 + i * 0.05, 10.0 + i * 0.05 + (i + 1) / 1e3,
                     10.0 + i * 0.05 + (i + 1) / 1e3 + 0.01 * (i + 1)) for i in range(100)]
    recs.append(fake_rec(8, 11, 0.0, 0.0, 5.0, 5.5))  # first token before the window
    run = fake_run(recs)
    ttft = spec.reader("end_to_end", "ttft_p90_ms")(run, "ttft_p90_ms")
    assert ttft == pytest.approx(float(np.percentile(np.arange(1, 101), 90)))
    tpot = spec.reader("per_layer", "tpot_p90_ms.ttft")(run, "tpot_p90_ms.ttft")
    assert tpot == pytest.approx(float(np.percentile(np.arange(1, 101), 90)))
    wait = spec.reader("per_layer", "queue_wait_p90_ms.ttft")(run, "queue_wait_p90_ms.ttft")
    assert wait == pytest.approx(0.0, abs=1e-6)


def test_counters_and_steps():
    run = fake_run([], stepline=[{"wall_s": 0.1, "phases": {"dispatch": 0.09}},
                                 {"wall_s": 0.3, "phases": {"dispatch": 0.21, "apply": 0.01}}])
    assert spec.reader("per_layer", "rows_per_step.tok_s")(run, "x") == 40.0
    assert spec.reader("per_layer", "dispatch_share.tok_s")(run, "x") == pytest.approx(75.0)
    assert spec.reader("per_layer", "device_idle.tok_s")(run, "x") is None


def test_work_counts_follow_the_admission_path():
    short = fake_rec(10, 4, 10.0, 10.5, 11.0, 12.0)  # one-shot: tokens 1.. decode
    long_ = fake_rec(20, 3, 10.0, 10.5, 11.0, 12.0)  # chunked: tokens 0.. decode
    run = fake_run([short, long_])
    assert stats.decode_contexts(run, short, "open", "close") == [11, 12, 13]
    assert stats.decode_contexts(run, long_, "open", "close") == [20, 21, 22]
    assert stats.admitted(run, 10.0, 11.0) == [short, long_]


@pytest.mark.parametrize("host", [True, False])
def test_trace_reduction(host):
    """The device's busy time and kernels from either trace; the idle gaps'
    labels only from the one with the host's operations."""
    tr = Trace(host=host)
    cuda, cpu = "CUDA", "CPU"

    class Ev:
        def __init__(self, name, start, dur, dev):
            self._n, self._s, self._d, self._dev = name, start, dur, dev

        def name(self):
            return self._n

        def start_ns(self):
            return self._s

        def duration_ns(self):
            return self._d

        def device_type(self):
            kinds = torch.autograd.DeviceType
            return kinds.CUDA if self._dev == cuda else kinds.CPU

    events = [Ev("k1(int)", 100, 100, cuda), Ev("k2", 150, 100, cuda),
              Ev("k1(int)", 400, 100, cuda), Ev("servebench.step", 0, 1000, cpu),
              Ev("aten::sort", 260, 100, cpu)]
    tr.reduce(events, 0, 1000)
    assert tr.window_s == pytest.approx(1e-6)
    assert tr.busy_s == pytest.approx(250e-9)
    assert tr.kernel_s["k1(int)"] == pytest.approx(200e-9)
    assert tr.device_ops[0] == ["k1", pytest.approx(200e-9)]
    if not host:
        assert tr.idle_gaps == []
        return
    labels = dict(tr.idle_gaps)
    assert labels["aten::sort"] == pytest.approx(150e-9)
    assert labels["servebench.step (python)"] == pytest.approx(600e-9)
    assert union([(0, 2), (1, 3), (5, 6)]) == [[0, 3], [5, 6]]
    assert host_label([], [], 5) == "outside a step"
    many = [(i, i + 1, "aten::add") for i in range(10, 2000)]
    assert host_label(many, [(0, 5000, "servebench.step")], 4000) == "servebench.step (python)"


def test_benchmark_json_keeps_the_contract():
    keys = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert set(BENCH) == keys
    assert 1 <= BENCH["run_seconds"] <= 51
    names = set()
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("servebench/")
        assert json.loads((ROOT / c["file"]).read_text())["source"] == c["source"]
        names.add(c["name"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (ROOT / "servebench/traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "servebench/limits" / f"{w['name']}.json").exists()
        reported = {m["name"] for m in spec.metrics(BENCH, w["name"], "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.metrics(BENCH, w["name"], "per_layer")
    for m in BENCH["end_to_end"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        for w in m["workloads"]:
            moved = {x["name"] for x in spec.metrics(BENCH, w, "end_to_end")}
            assert m["moves"] in moved
    assert len(json.dumps(BENCH)) < 64 * 1024
