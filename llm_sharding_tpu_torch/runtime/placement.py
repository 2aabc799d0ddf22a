"""Profiler-driven placement planning for disaggregated serving: the
port's own copy of ``llm_sharding_tpu/runtime/placement.py`` (numpy only),
the arithmetic unchanged.

The port's profiler (``profiler/profiler.py``, ``profiler/artifacts.py``;
``python -m llm_sharding_tpu_torch profile``) measures each device kind's
prefill and decode latency curves and least-squares-fits them into a
``profile.json``; this module is the half that CONSUMES the fits at serve
time. A ``profile.json`` of the JAX package's profiler has the same schema
and feeds it too.

- **ratio**: prefill and decode have opposite hardware profiles
  (compute-bound vs bandwidth-bound). Given the offered workload mix
  (average prompt tokens, average generated tokens), the fitted models
  say how much wall time a request spends in each phase — the
  prefill:decode replica ratio follows (``prefill_count``).
- **routing**: each request goes to the replica minimizing its PREDICTED
  TTFT (``predict_ttft`` / ``best_replica``): the prefill model applied
  to the replica's queued prefill backlog plus this request's UNCACHED
  prompt tokens (the radix-warmth signal folds in as a subtraction — a
  warm replica prefills less), plus the decode model's marginal per-token
  cost for each in-flight row the new prefill will stall.
- **role flips**: as the offered mix shifts, ``prefill_count`` moves and
  ``runtime/disagg.DisaggServer.rebalance()`` flips one replica at a
  time through the drain/spawn elasticity path.

Pure host-side numpy, importable without torch. A planner is OPTIONAL
everywhere: ``DisaggServer`` without one falls back to the router's
health/warmth/load pick.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence

import numpy as np

__all__ = ["FittedLatency", "PlacementPlanner", "read_profile_json"]


def read_profile_json(path: str) -> dict:
    """Read a saved ``profile.json`` back — accepts the file itself or the
    profile directory it was written into."""
    import os

    if os.path.isdir(path):
        path = os.path.join(path, "profile.json")
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass(frozen=True)
class FittedLatency:
    """One fitted latency curve T(x) = polyval(coeffs, x), as a
    ``profile.json`` stores it."""

    kind: str      # "linear" | "quadratic"
    coeffs: tuple  # highest-order first, like np.polyfit
    rmse: float = 0.0
    r2: float = 0.0

    def predict(self, x) -> float:
        """Predicted seconds at ``x`` (tokens), clamped non-negative — an
        extrapolated fit must never return a negative latency that would
        invert a routing comparison."""
        return float(
            max(np.polyval(np.asarray(self.coeffs, np.float64), float(x)),
                0.0)
        )

    def slope(self, x) -> float:
        """dT/dx at ``x`` — the marginal per-token cost (the decode fit is
        a CUMULATIVE latency curve, so its slope is the inter-token
        latency)."""
        d = np.polyder(np.asarray(self.coeffs, np.float64))
        return float(max(np.polyval(d, float(x)), 0.0))


def _pick_fit(fits: dict) -> FittedLatency:
    """The best available fit from a ``fit_latency_models`` dict (or its
    JSON form): highest R² wins, linear on ties (fewer degrees of freedom
    extrapolate more sanely past the measured sweep)."""
    if not fits:
        raise ValueError("no latency fits in this profile section")
    best: Optional[FittedLatency] = None
    for kind in ("linear", "quadratic"):  # linear first → wins R² ties
        f = fits.get(kind)
        if f is None:
            continue
        fl = FittedLatency(
            kind,
            tuple(float(c) for c in (
                f["coeffs"] if isinstance(f, dict) else f.coeffs
            )),
            float(f["rmse"] if isinstance(f, dict) else f.rmse),
            float(f["r2"] if isinstance(f, dict) else f.r2),
        )
        if best is None or fl.r2 > best.r2:
            best = fl
    return best


class PlacementPlanner:
    """TTFT-predicting router + prefill:decode ratio chooser over one
    device kind's fitted prefill/decode latency models. See the module
    docstring for what each decision consumes."""

    #: reference output-token count at which the decode fit's slope is
    #: evaluated (a quadratic cumulative fit has no single slope; the
    #: mid-scale marginal cost is the honest summary)
    ITL_REF_TOKENS = 64

    def __init__(self, prefill: FittedLatency, decode: FittedLatency):
        self.prefill = prefill
        self.decode = decode

    # ------------------------------------------------------- construction

    @classmethod
    def from_profile(cls, payload: dict) -> "PlacementPlanner":
        """Build from a ``profile.json`` payload (``{"prefill": {"fits":
        {...}}, "decode": {"fits": {...}}}``, each fit ``{"coeffs", "rmse",
        "r2"}``). Raises a
        curated ``ValueError`` when the profile lacks the prefill or
        decode sweep — the operator ran a partial profile."""
        for section in ("prefill", "decode"):
            if section not in payload or not payload[section].get("fits"):
                raise ValueError(
                    f"profile has no fitted {section!r} latency models — "
                    "re-run the profiler with both the prefill and decode "
                    "sweeps enabled (cli profile writes profile.json with "
                    "both fits)"
                )
        return cls(
            _pick_fit(payload["prefill"]["fits"]),
            _pick_fit(payload["decode"]["fits"]),
        )

    @classmethod
    def from_json(cls, path: str) -> "PlacementPlanner":
        """Load a saved ``profile.json`` (CLI: ``serve --profile-json``);
        accepts the file or the profile directory it was written into."""
        return cls.from_profile(read_profile_json(path))

    @classmethod
    def from_reports(cls, prefill_report, decode_report) -> "PlacementPlanner":
        """Build straight from two profiler reports (objects whose ``fits``
        maps ``"linear"`` / ``"quadratic"`` to fits with ``coeffs``,
        ``rmse`` and ``r2``), with no file round-trip."""
        return cls(
            _pick_fit(prefill_report.fits), _pick_fit(decode_report.fits)
        )

    # -------------------------------------------------------- predictions

    def prefill_s(self, tokens: float) -> float:
        """Predicted wall seconds to prefill ``tokens`` prompt tokens."""
        return self.prefill.predict(max(float(tokens), 0.0))

    def decode_itl_s(self) -> float:
        """Predicted marginal inter-token decode latency (the slope of the
        cumulative decode curve at ``ITL_REF_TOKENS``)."""
        return self.decode.slope(self.ITL_REF_TOKENS)

    def predict_ttft(
        self,
        prompt_tokens: int,
        cached_tokens: int = 0,
        backlog_tokens: int = 0,
        inflight_rows: int = 0,
    ) -> float:
        """Predicted submission→first-token seconds on a replica: the
        prefill model over the replica's queued prefill backlog plus this
        request's UNCACHED tokens (radix warmth subtracts — the cached
        prefix costs zero FLOPs), plus one marginal decode step per
        in-flight row (interleaved decode work ahead of the new
        admission)."""
        uncached = max(int(prompt_tokens) - int(cached_tokens), 1)
        return (
            self.prefill_s(int(backlog_tokens) + uncached)
            + int(inflight_rows) * self.decode_itl_s()
        )

    def best_replica(
        self, prompt_tokens: int, replicas: Sequence[dict]
    ) -> int:
        """Index of the replica with the lowest predicted TTFT. Each entry
        describes one candidate: ``{"cached_tokens", "backlog_tokens",
        "inflight_rows"}`` (missing keys default to 0). Ties keep the
        earliest index (stable — the caller orders by its own
        preference)."""
        if not replicas:
            raise ValueError("best_replica needs at least one candidate")
        preds = [
            self.predict_ttft(
                prompt_tokens,
                cached_tokens=r.get("cached_tokens", 0),
                backlog_tokens=r.get("backlog_tokens", 0),
                inflight_rows=r.get("inflight_rows", 0),
            )
            for r in replicas
        ]
        return int(np.argmin(preds))

    # --------------------------------------------------------- ratio/roles

    def prefill_share(
        self, avg_prompt_tokens: float, avg_new_tokens: float
    ) -> float:
        """Fraction of per-request wall time spent in prefill for the
        offered mix — the target fraction of replicas that should hold the
        prefill role."""
        tp = self.prefill_s(max(float(avg_prompt_tokens), 1.0))
        td = max(float(avg_new_tokens), 1.0) * self.decode_itl_s()
        if tp + td <= 0:
            return 0.5  # degenerate fits: split evenly
        return tp / (tp + td)

    def prefill_count(
        self, total: int, avg_prompt_tokens: float, avg_new_tokens: float
    ) -> int:
        """Prefill replicas out of ``total`` for the offered mix, clamped
        to [1, total − 1] — a disaggregated pool always keeps at least one
        replica on each side."""
        total = int(total)
        if total < 2:
            return max(total, 0)
        n = int(round(total * self.prefill_share(
            avg_prompt_tokens, avg_new_tokens
        )))
        return min(max(n, 1), total - 1)
