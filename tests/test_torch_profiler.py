"""The port's capability profiler (``llm_sharding_tpu_torch/profiler/``)
against the JAX package's (``llm_sharding_tpu/profiler/``), on the CPU.

The same inputs go through both: the fits, the similarity verdict and the
memory accounting on the same numbers (equal to 1e-12, the accounting
exactly, for every preset at bf16 / f32 / int8); the profiled prefill step
of tiny llama and GPT-2 models (weights carried from the JAX params) equal
to the JAX ``forward`` to 1e-5 relative; the reports' structure; the same
scripted samples giving the same ``c_k``, fits and decode curve; the chain
calibration's scripted runners; the hop latency's fields; cold start on
stores of either package; ``profile.json`` written from the same reports;
and the ``profile`` command's payload against the JAX command's.
"""

import contextlib
import dataclasses
import functools
import io
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the JAX package is the reference
import jax.numpy as jnp  # noqa: E402

from llm_sharding_tpu.models import config as jcfg  # noqa: E402  (models before ops)
from llm_sharding_tpu.models import gpt2 as jgpt2  # noqa: E402
from llm_sharding_tpu.models import llama as jllama  # noqa: E402
from llm_sharding_tpu.models.cache import init_cache as jinit_cache  # noqa: E402
from llm_sharding_tpu import cli as jcli  # noqa: E402
from llm_sharding_tpu.parallel.pipeline import model_fns as jmodel_fns  # noqa: E402
from llm_sharding_tpu.parallel.placement import PlacementSpec as JSpec  # noqa: E402
from llm_sharding_tpu.profiler import artifacts as jart  # noqa: E402
from llm_sharding_tpu.profiler import profiler as jprof  # noqa: E402
from llm_sharding_tpu.runtime.generate import forward_fn_for  # noqa: E402
from llm_sharding_tpu.utils import shard_store as jstore  # noqa: E402
from llm_sharding_tpu_torch import cli as tcli  # noqa: E402
from llm_sharding_tpu_torch.models import config as tcfg  # noqa: E402
from llm_sharding_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from llm_sharding_tpu_torch.models import llama as tllama  # noqa: E402
from llm_sharding_tpu_torch.parallel.placement import PlacementSpec as TSpec  # noqa: E402
from llm_sharding_tpu_torch.profiler import artifacts as tart  # noqa: E402
from llm_sharding_tpu_torch.profiler import profiler as tprof  # noqa: E402
from llm_sharding_tpu_torch.runtime import placement as tpl  # noqa: E402
from llm_sharding_tpu_torch.utils import shard_store as tstore  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-12
LENGTHS = (8, 16, 32, 64, 128, 256, 512)
MODELS = {
    "llama": (jcfg.tiny_llama, jllama, tcfg.tiny_llama, tllama),
    "gpt2": (jcfg.tiny_gpt2, jgpt2, tcfg.tiny_gpt2, tgpt2),
}
PRESETS = ("llama2_7b", "llama2_13b", "llama3_8b", "llama31_8b", "llama32_3b", "llama2_70b",
           "gpt2_small", "qwen25_7b", "gemma_2b", "gemma_7b", "tiny_qwen2", "tiny_llama",
           "tiny_gemma", "tiny_gpt2")
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32),
          "int8": (jnp.int8, torch.int8)}


def close(a, b, rel=REL):
    """Equal to ``rel`` relative (NaN equal to NaN, inf to inf)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=rel, atol=0.0, equal_nan=True)


def same_fits(jf: dict, tf: dict, rel=REL):
    assert set(jf) == set(tf)
    for k in jf:
        assert jf[k].kind == tf[k].kind
        close(jf[k].coeffs, tf[k].coeffs, rel)
        close([jf[k].rmse, jf[k].r2], [tf[k].rmse, tf[k].r2], rel)


# ------------------------------------------------------------------- fits

@pytest.mark.parametrize("n", [1, 2, 7])
@pytest.mark.parametrize("shape", ["linear", "quadratic"])
def test_fit_latency_models_equal_jax(shape, n):
    rng = np.random.default_rng(7)
    x = np.asarray(LENGTHS[:n], np.float64)
    y = 3e-3 * x + 0.5 if shape == "linear" else 2e-5 * x**2 + 1e-3 * x + 0.2
    y = y + rng.normal(0.0, 1e-3, n)
    jf, tf = jprof.fit_latency_models(x, y), tprof.fit_latency_models(x, y)
    same_fits(jf, tf)
    assert set(tf) == {"linear", "quadratic"}.intersection(
        ["linear"] * (n >= 2) + ["quadratic"] * (n >= 3))
    for k in tf:
        close(tf[k].predict(x), jf[k].predict(x))


def _reports(mod, lengths, lat, counts, cums):
    pre = mod.PrefillReport(
        lengths=tuple(lengths), latencies_s=tuple(lat),
        capability_c_k=float(np.mean(np.asarray(lat) / np.asarray(lengths))) / 28,
        fits=mod.fit_latency_models(lengths, lat), num_layers_measured=28, num_layers_model=28,
    )
    marginal = np.diff([0.0] + list(cums)) / np.diff([0] + list(counts))
    dec = mod.DecodeReport(
        token_counts=tuple(counts), cumulative_s=tuple(cums),
        capability_c_k=float(np.mean(marginal)) / 28, fits=mod.fit_latency_models(counts, cums),
    )
    return pre, dec


VERDICT_CASES = {
    # every ratio defined, similar or not
    "similar": ((8, 16, 32, 64), (0.011, 0.021, 0.043, 0.083), (8, 16, 24, 32),
                (0.010, 0.021, 0.031, 0.042)),
    "dissimilar": ((8, 16, 32, 64), (0.011, 0.021, 0.043, 0.083), (8, 16, 24, 32),
                   (0.08, 0.17, 0.24, 0.33)),
    # two points each: no quadratic fit, its ratio NaN
    "linear_only": ((8, 16), (0.011, 0.021), (8, 16), (0.012, 0.025)),
    # one point each: no fit at all, both fitted ratios NaN
    "no_fits": ((8,), (0.011,), (8,), (0.012,)),
    # a prefill marginal of 0 at mid-sweep: the quadratic ratio is inf
    "flat_prefill": ((8, 16, 32), (0.5, 0.5, 0.5), (8, 16, 24), (0.01, 0.02, 0.03)),
}


@pytest.mark.parametrize("case", sorted(VERDICT_CASES))
def test_similarity_verdict_equal_jax(case):
    lengths, lat, counts, cums = VERDICT_CASES[case]
    jv = jprof.Profiler.similarity_verdict(*_reports(jprof, lengths, lat, counts, cums))
    tv = tprof.Profiler.similarity_verdict(*_reports(tprof, lengths, lat, counts, cums))
    assert tv.similar == jv.similar and tv.threshold == jv.threshold == 0.30
    close([tv.avg_ratio, tv.slope_ratio, tv.quadratic_marginal_ratio],
          [jv.avg_ratio, jv.slope_ratio, jv.quadratic_marginal_ratio])
    if case == "no_fits":
        assert np.isnan(tv.slope_ratio) and np.isnan(tv.quadratic_marginal_ratio)
    if case == "linear_only":
        assert np.isnan(tv.quadratic_marginal_ratio) and np.isfinite(tv.slope_ratio)


# ----------------------------------------------------------- memory accounting

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("preset", PRESETS)
def test_memory_accounting_equals_jax(preset, dtype):
    jc, tc = getattr(jcfg, preset)(), getattr(tcfg, preset)()
    jd, td = DTYPES[dtype]
    L = tc.num_hidden_layers
    assert tprof.layer_param_bytes(tc, td) == jprof.layer_param_bytes(jc, jd)
    assert (tprof.kv_cache_bytes_per_layer(tc, 4, 2048, td)
            == jprof.kv_cache_bytes_per_layer(jc, 4, 2048, jd))
    for hbm in (16 * 1024**3, 80 * 1024**3, 10**6):
        for with_head in (True, False):
            kw = dict(batch_size=2, kv_capacity=1024, hbm_bytes=hbm, with_head=with_head)
            assert (tprof.max_layers_fit(tc, param_dtype=td, **kw)
                    == jprof.max_layers_fit(jc, param_dtype=jd, **kw))
    even, ragged = (4, ((0, 1), (1, L))) if L >= 4 else (L, ((0, 1), (1, L)))
    for jspec, tspec in ((JSpec.balanced(L, even), TSpec.balanced(L, even)),
                         (JSpec.from_ranges(ragged, L), TSpec.from_ranges(ragged, L))):
        for head in ((None, None), (jnp.bfloat16, torch.bfloat16)):
            assert tprof.stage_memory_bytes(
                tc, tspec, batch_size=2, kv_capacity=512, param_dtype=td, head_dtype=head[1],
            ) == jprof.stage_memory_bytes(
                jc, jspec, batch_size=2, kv_capacity=512, param_dtype=jd, head_dtype=head[0],
            )


def test_detect_hbm_bytes_without_a_card():
    """On the CPU the memory is not determinable: ``None``, as the JAX
    function returns on a host it cannot read, and ``max_layers_fit``
    without ``hbm_bytes`` raises the JAX message."""
    assert tprof.detect_hbm_bytes("cpu") is None
    if not torch.cuda.is_available():
        assert tprof.detect_hbm_bytes() is None
    with pytest.raises(ValueError, match="pass hbm_bytes explicitly"):
        tprof.max_layers_fit(tcfg.tiny_llama(), device="cpu")


# ------------------------------------------------------------------ Profiler

@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    """(name, JAX cfg, JAX params, port cfg, port params): f32 weights made
    by the JAX package and carried over."""
    jc_fn, jmod, tc_fn, tmod = MODELS[request.param]
    jc, tc = jc_fn(), tc_fn()
    tree = jax.tree.map(np.asarray, jmod.init_params(jc, jax.random.key(3), dtype=jnp.float32))
    return (request.param, jc, jax.tree.map(jnp.asarray, tree), tc,
            tmod.params_from_numpy(tc, tree, device="cpu"))


def _layer_slice(model, a, b):
    _, jc, jp, tc, tp = model
    return ({**jp, "layers": jax.tree.map(lambda x: x[a:b], jp["layers"])},
            {**tp, "layers": tp["layers"][a:b]})


def test_profiled_prefill_step_equals_jax_forward(model, monkeypatch):
    """Every profiled prefill step's logits equal the JAX ``forward`` of the
    same zero prompt to 1e-5 of the logits' scale."""
    name, jc, jp, tc, tp = model
    outs = {}

    def capture(fn, device):
        out = fn()
        outs.setdefault(out.shape[1], out)
        return 1e-3

    monkeypatch.setattr(tprof, "_timeit", capture)
    rep = tprof.Profiler(tc, tp, dtype=torch.float32).profile_prefill(
        lengths=(8, 16, 32, 4096), repeats=1)
    assert rep.lengths == (8, 16, 32) and sorted(outs) == [8, 16, 32]
    fwd = forward_fn_for(jc)
    for S in rep.lengths:
        ids = jnp.zeros((1, S), jnp.int32)
        pos = jnp.arange(S, dtype=jnp.int32)[None]
        want = np.asarray(fwd(jc, jp, ids, jinit_cache(jc, 1, S, dtype=jnp.float32), pos)[0])
        got = outs[S].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_report_structure_equals_jax(model):
    """Measured for real on both: the lengths after the max-position guard,
    the layers held and in the model, the fit keys."""
    name, jc, jp, tc, tp = model
    lengths = (8, 16, 32, 4096)
    jr = jprof.Profiler(jc, jp, dtype=jnp.float32).profile_prefill(lengths=lengths, repeats=1)
    tr = tprof.Profiler(tc, tp, dtype=torch.float32).profile_prefill(lengths=lengths, repeats=1)
    assert tr.lengths == jr.lengths == (8, 16, 32)
    assert (tr.num_layers_measured, tr.num_layers_model) == (
        jr.num_layers_measured, jr.num_layers_model)
    assert set(tr.fits) == set(jr.fits) == {"linear", "quadratic"}
    assert all(t > 0 for t in tr.latencies_s) and tr.capability_c_k > 0


def _scripted(monkeypatch, mod, values, clock, runs_fn: bool):
    """``mod``'s timer returns ``values`` in order (without running the
    step unless ``runs_fn``) and its clock reads ``clock`` in order."""
    it, ticks = iter(values), iter(clock)

    def timeit(fn, *dev):
        if runs_fn:
            fn()
        return next(it)

    monkeypatch.setattr(mod, "_timeit", timeit)
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(
        perf_counter=lambda: next(ticks), sleep=lambda s: None))


def test_scripted_samples_give_jax_numbers(model, monkeypatch):
    """One scripted latency per timed call (warm-ups included) and one
    scripted clock: ``c_k``, the fits and the decode curve equal JAX's, for
    the whole model and for a 2-layer slice (normalised to the model's
    layers as JAX does)."""
    name, jc, jp, tc, tp = model
    lengths, repeats = (8, 16, 32, 64, 4096), 2
    n_calls = 2 + 4 + 4 * repeats
    values = list(np.random.default_rng(1).uniform(1e-3, 9e-3, n_calls))
    clock = [0.0] + list(np.cumsum(np.random.default_rng(2).uniform(0.01, 0.05, 4)))
    reports = {}
    for tag, mod, cfg, params, dt, runs in (
            ("jax", jprof, jc, jp, jnp.float32, False),
            ("port", tprof, tc, tp, torch.float32, True)):
        _scripted(monkeypatch, mod, values, clock, runs)
        prof = mod.Profiler(cfg, params, dtype=dt)
        reports[tag] = (prof.profile_prefill(lengths=lengths, repeats=repeats),
                        prof.profile_decode(max_tokens=16, prompt_len=8, measure_every=4))
        jsl, tsl = _layer_slice(model, 1, 3)
        _scripted(monkeypatch, mod, values, clock, runs)
        sliced = mod.Profiler(cfg, jsl if tag == "jax" else tsl, dtype=dt)
        assert sliced.num_layers_held == 2
        reports[tag] += (sliced.profile_prefill(lengths=lengths, repeats=repeats),)
    (jpre, jdec, jsl_rep), (tpre, tdec, tsl_rep) = reports["jax"], reports["port"]
    for j, t in ((jpre, tpre), (jsl_rep, tsl_rep)):
        assert t.lengths == j.lengths == (8, 16, 32, 64)
        close(t.latencies_s, j.latencies_s)
        close(t.capability_c_k, j.capability_c_k)
        same_fits(j.fits, t.fits)
        assert (t.num_layers_measured, t.num_layers_model) == (
            j.num_layers_measured, j.num_layers_model)
    assert tsl_rep.num_layers_measured == 2
    close(tsl_rep.capability_c_k, tpre.capability_c_k * tc.num_hidden_layers / 2)
    assert tdec.token_counts == jdec.token_counts == (4, 8, 12, 16)
    close(tdec.cumulative_s, jdec.cumulative_s)
    close(tdec.capability_c_k, jdec.capability_c_k)
    same_fits(jdec.fits, tdec.fits)


def test_decode_on_a_slice_raises_as_jax(model):
    name, jc, jp, tc, tp = model
    jsl, tsl = _layer_slice(model, 0, 2)
    with pytest.raises(ValueError, match="full model") as je:
        jprof.Profiler(jc, jsl, dtype=jnp.float32).profile_decode(max_tokens=4)
    with pytest.raises(ValueError, match="full model") as te:
        tprof.Profiler(tc, tsl, dtype=torch.float32).profile_decode(max_tokens=4)
    assert str(te.value) == str(je.value)


def test_stage_profile_of_a_slice(model, monkeypatch):
    """A 2-layer slice times standalone (JAX ``test_profiler.py``'s
    assisted-profiling case), and each timed pass equals the JAX stage's on
    the same synthetic activations."""
    name, jc, jp, tc, tp = model
    jsl, tsl = _layer_slice(model, 2, 4)
    prof = tprof.Profiler(tc, tsl, dtype=torch.float32)
    assert prof.num_layers_held == 2
    assert prof.profile_stage(seq_len=16, repeats=2) > 0
    outs = []
    monkeypatch.setattr(tprof, "_timeit", lambda fn, device: outs.append(fn()) or 1e-3)
    assert prof.profile_stage(seq_len=16, repeats=2) == 1e-3 and len(outs) == 3
    pos = jnp.arange(16, dtype=jnp.int32)[None]
    want = np.asarray(jmodel_fns(jc).stage(
        jc, jsl["layers"], jnp.zeros((1, 16, jc.hidden_size), jnp.float32),
        jinit_cache(jc, 1, 16, num_layers=2, dtype=jnp.float32), pos, None)[0])
    for got in outs:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(want).max(), 1.0))


# ------------------------------------------------------------ hop latency

def _chain_cases():
    """The two scripted cases of ``tests/test_profiler.py``: a first chain
    delta swamped by sync jitter, and hops that never beat the floor."""
    per_hop = 1e-6

    def grows():
        jitter = iter([0.0, 1e-3, 5e-4] + [0.0, 2e-3, 0.0, 2e-3, 0.0, 2e-3] + [0.0] * 100)
        return lambda n: (lambda: 0.1 + next(jitter, 0.0) + n * per_hop), {}

    def immeasurable():
        calls = {"n": 0}

        def make_run(n):
            def run():
                calls["n"] += 1
                return 0.1 + (1e-3 if calls["n"] % 2 else 0.0)

            return run

        return make_run, {"cap": 10_000}

    return {"grows_past_jitter": grows, "caps_when_immeasurable": immeasurable}


@pytest.mark.parametrize("case", sorted(_chain_cases()))
def test_calibrate_chain_equals_jax(case):
    got = []
    for mod in (jprof, tprof):
        make_run, kw = _chain_cases()[case]()
        n_long, est, run_long = mod._calibrate_chain(make_run, 32, **kw)
        got.append((n_long, est, run_long is None))
    assert got[0][0] == got[1][0] and got[0][2] == got[1][2]
    close(got[1][1], got[0][1])


def test_measure_hop_latency_ring8_cpu():
    rep = tprof.measure_hop_latency(["cpu"] * 8, hidden_size=64, n_hops=32, repeats=5)
    assert set(dataclasses.asdict(rep)) == set(
        f.name for f in dataclasses.fields(jprof.HopLatencyReport))
    assert rep.bytes_per_hop == 1 * 64 * jnp.dtype(jnp.bfloat16).itemsize
    assert rep.p50_us >= 0 and rep.p99_us >= rep.p50_us and rep.mean_us >= 0
    assert rep.hops_per_sample > 0 and rep.samples == 5


# ------------------------------------------------------------- cold start

def test_cold_start_on_stores_of_either_package(tmp_path):
    """f32 stores of either package through both packages' cold start. A
    bf16 store carries ``<name>__dtype`` tag entries, which the JAX cold
    start passes to ``jnp.asarray`` and fails on; the port's decodes them,
    so it also reads a bf16 store."""
    jc, tc = jcfg.tiny_llama(), tcfg.tiny_llama()
    jdir, tdir = str(tmp_path / "jax_store"), str(tmp_path / "port_store")
    jstore.save_shards(jc, jllama.init_params(jc, jax.random.key(0), dtype=jnp.float32), jdir)
    tstore.save_shards(tc, tllama.init_params(tc, seed=0, dtype=torch.float32, device="cpu"),
                       tdir)
    bf16 = str(tmp_path / "jax_bf16")
    jstore.save_shards(jc, jllama.init_params(jc, jax.random.key(0), dtype=jnp.bfloat16), bf16)
    rep = tprof.profile_cold_start(bf16, device="cpu")
    assert rep.num_layers == len(rep.per_layer_s) == tc.num_hidden_layers
    for store in (jdir, tdir):
        j = jprof.profile_cold_start(store, dtype=jnp.float32)
        t = tprof.profile_cold_start(store, dtype=torch.float32, device="cpu")
        assert t.num_layers == j.num_layers == tc.num_hidden_layers
        assert len(t.per_layer_s) == len(j.per_layer_s) == tc.num_hidden_layers
        assert t.total_s >= max(t.per_layer_s) > 0
        part = tprof.profile_cold_start(store, start=1, end=3, device="cpu")
        assert part.num_layers == 2 == len(part.per_layer_s)


# -------------------------------------------------------------- artifacts

def _all_reports(mod):
    lengths, lat = (8, 16, 32, 64), (0.011, 0.021, 0.043, 0.083)
    pre, dec = _reports(mod, lengths, lat, (8, 16, 24, 32), (0.010, 0.021, 0.031, 0.042))
    return dict(
        prefill=pre, decode=dec, verdict=mod.Profiler.similarity_verdict(pre, dec),
        cold_start=mod.ColdStartReport(total_s=0.5, per_layer_s=(0.2, 0.3), num_layers=2),
        hop=mod.HopLatencyReport(p50_us=3.5, p99_us=4.25, mean_us=3.75, bytes_per_hop=8192,
                                 hops_per_sample=100000, samples=30),
        extra={"config": json.loads(tcfg.tiny_llama().to_json()), "max_layers_fit": 3,
               "suggested_placement": [[0, 2], [2, 4]]},
    )


def test_profile_json_equals_jax_and_loads_both_ways(tmp_path):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jpay = jart.save_profile_artifacts(jdir, **_all_reports(jprof))
    tpay = tart.save_profile_artifacts(tdir, **_all_reports(tprof))
    assert tpay == jpay
    with open(os.path.join(jdir, "profile.json")) as f:
        jfile = json.load(f)
    with open(os.path.join(tdir, "profile.json")) as f:
        tfile = json.load(f)
    assert tfile == jfile
    assert tart.load_profile(jdir) == jart.load_profile(tdir) == tfile
    assert tart.load_profile(os.path.join(jdir, "profile.json")) == jfile
    reps = _all_reports(tprof)
    planners = [tpl.PlacementPlanner.from_json(jdir), tpl.PlacementPlanner.from_json(tdir),
                tpl.PlacementPlanner.from_reports(reps["prefill"], reps["decode"])]
    for args in ((512,), (2048, 1024, 4096, 6), (17, 0, 0, 1)):
        got = [p.predict_ttft(*args) for p in planners]
        close(got[1:], [got[0]] * 2)
    close([p.decode_itl_s() for p in planners], [planners[0].decode_itl_s()] * 3)


# -------------------------------------------------------------------- CLI

def _run(mod, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_profile_command_payload_equals_jax(tmp_path, monkeypatch):
    """The command on the CPU: the JAX command's keys (``config`` among
    them), its ``max_layers_fit`` and its placement. The hop chains are
    calibrated to 10 ms of hop work in both packages (0.4 s by default) to
    keep the test short; the measurement runs as in the command."""
    for mod in (jprof, tprof):
        monkeypatch.setattr(mod, "_calibrate_chain",
                            functools.partial(mod._calibrate_chain, target_s=0.01))
    args = ["profile", "--preset", "tiny_llama", "--dtype", "f32", "--decode-tokens", "8",
            "--hbm-gib", "1", "--suggest-stages", "2", "--hops", "2"]
    jrc, jout, _ = _run(jcli, args + ["--out", str(tmp_path / "jax")])
    trc, tout, terr = _run(tcli, args + ["--device", "cpu", "--out", str(tmp_path / "port")])
    assert jrc == trc == 0
    jpay, tpay = json.loads(jout), json.loads(tout)
    assert set(tpay) == set(jpay) >= {"config", "max_layers_fit", "suggested_placement",
                                      "hop_latency", "prefill", "decode", "similarity"}
    assert tpay["config"] == jpay["config"]
    assert tpay["max_layers_fit"] == jpay["max_layers_fit"]
    assert tpay["suggested_placement"] == jpay["suggested_placement"] == [[0, 2], [2, 4]]
    for key in ("prefill", "decode", "similarity", "hop_latency"):
        assert set(tpay[key]) == set(jpay[key])
    assert tpay["prefill"]["lengths"] == jpay["prefill"]["lengths"] == [8, 16, 32, 64, 128]
    assert tpay["decode"]["token_counts"] == jpay["decode"]["token_counts"] == [8]
    assert tpay["hop_latency"]["bytes_per_hop"] == jpay["hop_latency"]["bytes_per_hop"]
    assert f"artifacts -> {tmp_path / 'port'}" in terr
    assert tart.load_profile(str(tmp_path / "port")) == tpay


def test_profile_without_device_names_the_missing_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists here")
    res = subprocess.run(
        [sys.executable, "-m", "llm_sharding_tpu_torch", "profile", "--preset", "tiny_llama",
         "--out", str(tmp_path)], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "no CUDA device is available" in res.stderr
    assert not os.path.exists(os.path.join(tmp_path, "profile.json"))


def test_profiler_imports_no_jax():
    code = (
        "import sys\n"
        "import llm_sharding_tpu_torch.profiler, llm_sharding_tpu_torch.profiler.artifacts\n"
        "import llm_sharding_tpu_torch.cli\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'llm_sharding_tpu' or m.startswith('llm_sharding_tpu.')]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
