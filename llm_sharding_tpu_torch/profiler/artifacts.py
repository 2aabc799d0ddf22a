"""Profiler result persistence: the port of
``llm_sharding_tpu/profiler/artifacts.py``.

``profile.json`` holds everything placement reads (the fits, the
capabilities, the similarity verdict, cold start, hop latency), with the
JAX file's keys and nesting, so either package's planner reads either
package's file. The fitted-curve PNGs are optional, as in JAX: with no
matplotlib the payload's ``"plot"`` is ``null``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import numpy as np

from .profiler import (
    ColdStartReport,
    DecodeReport,
    HopLatencyReport,
    PrefillReport,
    SimilarityVerdict,
)


def _to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: _to_jsonable(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    return obj


def _plot_fit(path: str, xs, ys, fits, xlabel: str, title: str) -> bool:
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return False
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(xs, ys, "o", label="measured")
    grid = np.linspace(min(xs), max(xs), 100)
    for kind, fit in fits.items():
        ax.plot(
            grid,
            fit.predict(grid),
            label=f"{kind} fit (R²={fit.r2:.4f}, RMSE={fit.rmse:.2e})",
        )
    ax.set_xlabel(xlabel)
    ax.set_ylabel("latency (s)")
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return True


def save_profile_artifacts(
    out_dir: str,
    *,
    prefill: Optional[PrefillReport] = None,
    decode: Optional[DecodeReport] = None,
    verdict: Optional[SimilarityVerdict] = None,
    cold_start: Optional[ColdStartReport] = None,
    hop: Optional[HopLatencyReport] = None,
    extra: Optional[dict] = None,
) -> dict:
    """Write ``profile.json`` (+ fitted-curve PNGs when matplotlib is
    available) under ``out_dir``; returns the JSON-able payload."""
    os.makedirs(out_dir, exist_ok=True)
    payload: dict[str, Any] = {}
    if prefill is not None:
        payload["prefill"] = _to_jsonable(prefill)
        payload["prefill"]["plot"] = (
            "prefill_fit.png"
            if _plot_fit(
                os.path.join(out_dir, "prefill_fit.png"),
                prefill.lengths, prefill.latencies_s, prefill.fits,
                "prompt tokens", "prefill latency vs prompt length",
            )
            else None
        )
    if decode is not None:
        payload["decode"] = _to_jsonable(decode)
        payload["decode"]["plot"] = (
            "decode_fit.png"
            if _plot_fit(
                os.path.join(out_dir, "decode_fit.png"),
                decode.token_counts, decode.cumulative_s, decode.fits,
                "output tokens", "cumulative decode latency",
            )
            else None
        )
    if verdict is not None:
        payload["similarity"] = _to_jsonable(verdict)
    if cold_start is not None:
        payload["cold_start"] = _to_jsonable(cold_start)
    if hop is not None:
        payload["hop_latency"] = _to_jsonable(hop)
    if extra:
        payload.update(_to_jsonable(extra))
    with open(os.path.join(out_dir, "profile.json"), "w") as f:
        json.dump(payload, f, indent=2)
    return payload


def load_profile(path: str) -> dict:
    """Read a saved ``profile.json`` back (the file itself or the directory
    it was written into): the read half of ``save_profile_artifacts``,
    delegated to the planner's reader (``runtime/placement``), so the file
    convention lives in one place."""
    from ..runtime.placement import read_profile_json

    return read_profile_json(path)
