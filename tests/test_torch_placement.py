"""The port's placement planner (``runtime/placement.py``) against the JAX
package's on hand-written payloads of the profiler's ``profile.json``
schema (the port has no profiler yet): the picked fits, every prediction
(``predict``, ``slope``, ``prefill_s``, ``decode_itl_s``, ``predict_ttft``,
``prefill_share``) to 1e-12 relative, ``best_replica`` and
``prefill_count`` exactly, ``from_json`` on a file and on its directory,
``from_reports`` on report-like objects, and the refusals with the JAX
messages.
"""

import json
import types

import numpy as np
import pytest

pytest.importorskip("jax")  # the JAX package is the reference

from llm_sharding_tpu.runtime import placement as jpl
from llm_sharding_tpu_torch.runtime import placement as tpl

REL = 1e-12


def fit(kind, coeffs, rmse=0.0, r2=0.99):
    return {"kind": kind, "coeffs": list(coeffs), "rmse": rmse, "r2": r2}


PROFILES = {
    "linear": {
        "prefill": {"fits": {"linear": fit("linear", (2.5e-4, 3e-3), 1e-4, 0.998)}},
        "decode": {"fits": {"linear": fit("linear", (1.9e-2, 4e-3), 2e-3, 0.97)}},
    },
    "quadratic_wins": {
        "prefill": {"fits": {"linear": fit("linear", (1e-3, 0.0), 1.0, 0.5),
                             "quadratic": fit("quadratic", (1e-7, 2e-4, 1e-3), 0.1, 0.99)}},
        "decode": {"fits": {"linear": fit("linear", (1.2e-2, 0.0), 0.0, 0.99),
                            "quadratic": fit("quadratic", (3e-6, 1e-2, 0.0), 0.0, 0.99)}},
    },
    "negative_intercept": {
        "prefill": {"fits": {"linear": fit("linear", (1e-3, -0.05))}},
        "decode": {"fits": {"quadratic": fit("quadratic", (-1e-5, 1e-3, 0.0))}},
    },
    "prefill_heavy": {
        "prefill": {"fits": {"linear": fit("linear", (0.01, 0.0))}},
        "decode": {"fits": {"linear": fit("linear", (1e-6, 0.0))}},
    },
    "decode_heavy": {
        "prefill": {"fits": {"linear": fit("linear", (1e-9, 0.0))}},
        "decode": {"fits": {"linear": fit("linear", (0.5, 0.0))}},
    },
}


def close(a, b):
    return a == b or abs(a - b) <= REL * max(abs(a), abs(b))


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_predictions_equal_jax(name):
    t = tpl.PlacementPlanner.from_profile(PROFILES[name])
    j = jpl.PlacementPlanner.from_profile(PROFILES[name])
    for side in ("prefill", "decode"):
        tf, jf = getattr(t, side), getattr(j, side)
        assert (tf.kind, tf.coeffs, tf.rmse, tf.r2) == (jf.kind, jf.coeffs, jf.rmse, jf.r2)
        for x in (0, 1, 17, 64, 511, 4096, 1e5):
            assert close(tf.predict(x), jf.predict(x)) and tf.predict(x) >= 0.0
            assert close(tf.slope(x), jf.slope(x))
    assert close(t.decode_itl_s(), j.decode_itl_s())
    rng = np.random.default_rng(len(name))
    for _ in range(40):
        p, c, b, i = (int(v) for v in rng.integers(0, 4096, 4))
        i %= 64
        assert close(t.predict_ttft(p, c, b, i), j.predict_ttft(p, c, b, i))
        assert close(t.prefill_s(p), j.prefill_s(p))
        new = int(rng.integers(1, 512))
        assert close(t.prefill_share(p, new), j.prefill_share(p, new))
        for total in (0, 1, 2, 3, 5, 8):
            assert t.prefill_count(total, p, new) == j.prefill_count(total, p, new)
        reps = [dict(cached_tokens=int(rng.integers(0, p + 1)),
                     backlog_tokens=int(rng.integers(0, 512)),
                     inflight_rows=int(rng.integers(0, 8))) for _ in range(3)]
        reps.append({})  # missing keys default to 0
        assert t.best_replica(p, reps) == j.best_replica(p, reps)


def test_skewed_profiles_flip_routing(tmp_path):
    """The fits decide: a prefill-dominant profile sends the request to the
    warm busy replica, a decode-dominant one to the cold idle one, in both
    packages (``from_json`` on a directory and on the file itself)."""
    replicas = [dict(cached_tokens=0, backlog_tokens=0, inflight_rows=0),
                dict(cached_tokens=96, backlog_tokens=0, inflight_rows=4)]
    got = []
    for name in ("prefill_heavy", "decode_heavy"):
        d = tmp_path / name
        d.mkdir()
        (d / "profile.json").write_text(json.dumps(PROFILES[name]))
        for pkg in (tpl, jpl):
            got.append(pkg.PlacementPlanner.from_json(str(d)).best_replica(100, replicas))
            got.append(pkg.PlacementPlanner.from_json(str(d / "profile.json"))
                       .best_replica(100, replicas))
        assert tpl.read_profile_json(str(d)) == jpl.read_profile_json(str(d)) == PROFILES[name]
    assert got == [1, 1, 1, 1, 0, 0, 0, 0]


def test_from_reports_and_pick_fit_objects():
    """``from_reports`` and ``_pick_fit`` take fit objects as well as dicts;
    linear wins an R² tie."""
    obj = lambda kind, coeffs, r2: types.SimpleNamespace(kind=kind, coeffs=coeffs, rmse=0.0, r2=r2)
    rep = types.SimpleNamespace(fits={"linear": obj("linear", (1e-3, 0.0), 0.9),
                                      "quadratic": obj("quadratic", (1e-6, 1e-3, 0.0), 0.9)})
    t = tpl.PlacementPlanner.from_reports(rep, rep)
    j = jpl.PlacementPlanner.from_reports(rep, rep)
    assert t.prefill.kind == j.prefill.kind == "linear"
    assert close(t.predict_ttft(300, 10, 20, 3), j.predict_ttft(300, 10, 20, 3))


@pytest.mark.parametrize("call", [
    lambda pkg: pkg.PlacementPlanner.from_profile({"prefill": {"fits": {}}}),
    lambda pkg: pkg.PlacementPlanner.from_profile({"decode": {"fits": {"linear": fit("linear", (1, 0))}}}),
    lambda pkg: pkg._pick_fit({}),
    lambda pkg: pkg.PlacementPlanner(pkg.FittedLatency("linear", (1.0, 0.0)),
                                     pkg.FittedLatency("linear", (1.0, 0.0))).best_replica(5, []),
], ids=["no_prefill_fits", "no_prefill_section", "empty_fits", "no_candidates"])
def test_refusals_equal_jax(call):
    with pytest.raises(ValueError) as t:
        call(tpl)
    with pytest.raises(ValueError) as j:
        call(jpl)
    assert str(t.value) == str(j.value)


def test_port_module_needs_neither_jax_nor_torch():
    import ast
    import pathlib

    src = pathlib.Path(tpl.__file__).read_text()
    roots = {a.name.split(".")[0] for n in ast.walk(ast.parse(src)) if isinstance(n, ast.Import)
             for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.ImportFrom) and n.level == 0 and n.module}
    assert not roots & {"jax", "torch", "llm_sharding_tpu"}
