"""What several metric readers share: percentiles and the work a run's
requests did between two moments."""

from __future__ import annotations

import numpy as np

from . import work


def percentile(values, q: float):
    """The ``q``-th percentile of ``values`` (linear between ranks), or None
    when there are none."""
    values = list(values)
    return float(np.percentile(values, q)) if values else None


def mean(values):
    """The mean of ``values``, or None when there are none."""
    values = list(values)
    return float(np.mean(values)) if values else None


def chunked(run, rec) -> bool:
    """Whether the request's prompt was admitted in chunks: past the
    server's ``prefill_chunk``, whose final prompt token then enters
    through the first decode step."""
    chunk = run.server.get("prefill_chunk")
    return chunk is not None and rec.plen > int(chunk)


def decode_contexts(run, rec, a: str, b: str) -> list:
    """Keys attended by each decode-made token the request got between marks
    ``a`` and ``b``: token ``j`` attends ``plen + j``."""
    first = 0 if chunked(run, rec) else 1
    lo, hi = max(rec.tokens_at(a), first), rec.tokens_at(b)
    return [rec.plen + j for j in range(lo, hi)]


def admitted(run, t0: float, t1: float) -> list:
    """Requests admitted (their prefill dispatched) in ``[t0, t1)``."""
    return [r for r in run.recs if r.req.started_at is not None and t0 <= r.req.started_at < t1]


def useful_flops(run, a: str, b: str, t0: float, t1: float) -> float:
    """The model's useful operations between marks ``a`` / ``b`` (tokens)
    and times ``t0`` / ``t1`` (admissions): the weights' products of every
    real token, the attention's visible pairs, and the head once for each
    token made. Padding is not counted."""
    d = run.dims
    total = 0.0
    for rec in run.recs:
        for ctx in decode_contexts(run, rec, a, b):
            total += work.token_flops(d, ctx) + work.head_flops(d)
    for rec in admitted(run, t0, t1):
        if chunked(run, rec):
            total += work.prefill_flops(d, rec.plen - 1)
        else:
            total += work.prefill_flops(d, rec.plen) + work.head_flops(d)
    return total
