"""Offline trace + step-profile analysis: merge JSONL span files, rebuild
the span trees, and attribute latency to phases; render step-profiler
captures into host/device attribution tables. The port's own copy of
``llm_sharding_tpu/obs/report.py`` (whole): its output on a file is the
JAX module's, byte for byte, whichever package wrote the file.

Every span carries a ``trace_id``, so merging files (one per server, plus
``.1`` rollovers) and grouping by it rebuilds each request's journey:
admission, prefill, decode runs, migration.

``python -m llm_sharding_tpu_torch trace-report <files...>`` drives this
module: per-phase duration percentiles, the top-N slowest traces with
their phase breakdown, a per-tenant rollup, and ``--trace ID`` to print
one trace's tree.

``python -m llm_sharding_tpu_torch step-report <files...>`` drives the
second half: it accepts ``/profilez`` capture bundles (single-server or a
``{"r<d>": bundle}`` fan-out), ``/debugz`` bundles (their ``recent_steps``
ring tails) or raw ``StepRecord`` lists, and renders per-phase host
attribution, host-occupancy-over-time, and the worst device-idle-bubble
steps — the offline view of ``obs/stepline``.

Stdlib-only: the report runs anywhere the files landed, with no torch and
no GPU.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

#: Span names that are per-request tree NODES (own span_id) vs leaf events.
ROOT_SPANS = ("ingress", "request")

#: Per-step loop spans with no request attribution — excluded from the
#: per-phase attribution table (they describe the server, not a request).
LOOP_SPANS = frozenset(("chunk", "apply"))


def load_events(paths) -> List[dict]:
    """Read span events from JSONL files, merged and sorted by timestamp,
    each tagged with its source file. Blank and corrupt lines are skipped —
    a crashed writer leaves at most one torn final line per file, and the
    report must run on exactly those files."""
    events: List[dict] = []
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn final line of a crashed writer
                if isinstance(ev, dict) and "span" in ev:
                    ev.setdefault("file", path)
                    events.append(ev)
    events.sort(key=lambda e: e.get("ts", 0.0))
    return events


class Trace:
    """One trace_id's spans, indexed for tree walks."""

    def __init__(self, trace_id: str):
        self.trace_id = trace_id
        self.spans: List[dict] = []
        self.by_id: Dict[str, dict] = {}

    def add(self, ev: dict) -> None:
        self.spans.append(ev)
        sid = ev.get("span_id")
        if sid is not None:
            self.by_id[sid] = ev

    @property
    def root(self) -> Optional[dict]:
        """The tree root: the ``ingress`` span when present (HTTP traffic),
        else the ``request`` span, else the earliest parentless span."""
        for name in ROOT_SPANS:
            for ev in self.spans:
                if ev["span"] == name and ev.get("parent") is None:
                    return ev
        for ev in self.spans:
            if ev.get("parent") is None:
                return ev
        return self.spans[0] if self.spans else None

    def children_of(self, span_id: str) -> List[dict]:
        return [e for e in self.spans if e.get("parent") == span_id]

    def orphans(self) -> List[dict]:
        """Spans whose ``parent`` id matches no span_id in the trace —
        a broken parent chain (the invariant the migration/hand-off tests
        assert empty)."""
        return [
            e for e in self.spans
            if e.get("parent") is not None and e["parent"] not in self.by_id
        ]

    @property
    def e2e_s(self) -> float:
        r = self.root
        return float(r.get("dur_s", 0.0)) if r else 0.0

    @property
    def tenant(self) -> Optional[str]:
        for ev in self.spans:
            if ev.get("tenant") is not None:
                return str(ev["tenant"])
        return None

    def first(self, name: str) -> Optional[dict]:
        for ev in self.spans:
            if ev["span"] == name:
                return ev
        return None


def build_traces(events) -> Dict[str, Trace]:
    """Group span events by trace_id (events without one — loop phases,
    process-level decision spans — are dropped)."""
    traces: Dict[str, Trace] = {}
    for ev in events:
        tid = ev.get("trace_id")
        if tid is None:
            continue
        tr = traces.get(tid)
        if tr is None:
            tr = traces[tid] = Trace(str(tid))
        tr.add(ev)
    return traces


def _pctile(vals: List[float], q: float) -> float:
    """Nearest-rank-with-interpolation percentile over a small list."""
    if not vals:
        return 0.0
    vals = sorted(vals)
    if len(vals) == 1:
        return vals[0]
    pos = q * (len(vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)


def phase_stats(traces: Dict[str, Trace]) -> List[dict]:
    """Per-phase duration stats over every trace: one row per span name
    carrying request attribution, sorted by total time descending — the
    answer to "where do the slow requests spend it"."""
    buckets: Dict[str, List[float]] = {}
    for tr in traces.values():
        for ev in tr.spans:
            if ev["span"] in LOOP_SPANS or "dur_s" not in ev:
                continue
            buckets.setdefault(ev["span"], []).append(float(ev["dur_s"]))
    rows = []
    for name, vals in buckets.items():
        rows.append({
            "phase": name,
            "count": len(vals),
            "p50_ms": _pctile(vals, 0.50) * 1e3,
            "p99_ms": _pctile(vals, 0.99) * 1e3,
            "total_s": sum(vals),
        })
    rows.sort(key=lambda r: -r["total_s"])
    return rows


def latency_stats(traces: Dict[str, Trace]) -> dict:
    """Request-level TTFT/ITL/e2e percentiles reconstructed from the span
    stream alone (no metrics scrape needed): TTFT from the ``request``
    spans' ``ttft_s``, ITL from the bucketed ``decode`` spans' per-token
    time, e2e from each trace's root span."""
    ttft = [
        float(ev["ttft_s"])
        for tr in traces.values()
        for ev in tr.spans
        if ev["span"] == "request" and "ttft_s" in ev
    ]
    itl = [
        float(ev["dur_s"]) / int(ev["tokens"])
        for tr in traces.values()
        for ev in tr.spans
        if ev["span"] == "decode" and ev.get("tokens") and "dur_s" in ev
    ]
    e2e = [tr.e2e_s for tr in traces.values() if tr.e2e_s > 0]
    out = {}
    for key, vals in (("ttft", ttft), ("itl", itl), ("e2e", e2e)):
        out[key] = {
            "count": len(vals),
            "p50_ms": _pctile(vals, 0.50) * 1e3,
            "p99_ms": _pctile(vals, 0.99) * 1e3,
        }
    return out


def tenant_rollup(traces: Dict[str, Trace]) -> List[dict]:
    per: Dict[str, List[Trace]] = {}
    for tr in traces.values():
        per.setdefault(tr.tenant or "-", []).append(tr)
    rows = []
    for tenant, trs in sorted(per.items()):
        e2e = [t.e2e_s for t in trs]
        toks = sum(
            int(ev.get("tokens", 0))
            for t in trs for ev in t.spans if ev["span"] == "request"
        )
        rows.append({
            "tenant": tenant,
            "traces": len(trs),
            "tokens": toks,
            "e2e_p50_ms": _pctile(e2e, 0.50) * 1e3,
            "e2e_p99_ms": _pctile(e2e, 0.99) * 1e3,
        })
    return rows


def format_tree(tr: Trace) -> str:
    """One trace's span tree, indented, children in timestamp order."""
    lines = [f"trace {tr.trace_id}"]
    seen = set()

    def fields_of(ev: dict) -> str:
        skip = {
            "ts", "span", "dur_s", "trace_id", "span_id", "parent", "file",
            "src",
        }
        parts = [
            f"{k}={ev[k]}" for k in sorted(ev) if k not in skip
        ]
        return (" " + " ".join(parts)) if parts else ""

    def emit(ev: dict, depth: int) -> None:
        seen.add(id(ev))
        dur = (
            f" {float(ev['dur_s']) * 1e3:.1f}ms" if "dur_s" in ev else ""
        )
        src = f" [{ev['src']}]" if ev.get("src") else ""
        lines.append(
            "  " * depth + f"{ev['span']}{dur}{src}{fields_of(ev)}"
        )
        sid = ev.get("span_id")
        if sid is not None:
            for child in sorted(
                tr.children_of(sid), key=lambda e: e.get("ts", 0.0)
            ):
                if id(child) not in seen:
                    emit(child, depth + 1)

    root = tr.root
    if root is not None:
        emit(root, 1)
    for ev in sorted(tr.spans, key=lambda e: e.get("ts", 0.0)):
        if id(ev) not in seen:
            emit(ev, 1)  # orphans and detached roots, flagged by position
    return "\n".join(lines)


def render_report(
    events, top: int = 5, trace_id: Optional[str] = None
) -> str:
    """The trace-report text: phase attribution, latency percentiles,
    slowest traces, tenant rollup — or one trace's tree with ``trace_id``."""
    traces = build_traces(events)
    if trace_id is not None:
        tr = traces.get(trace_id)
        if tr is None:
            return (
                f"trace {trace_id!r} not found "
                f"({len(traces)} trace(s) in the input)"
            )
        return format_tree(tr)
    lines = [
        f"{len(events)} span(s), {len(traces)} trace(s)",
        "",
        "per-phase latency (all traces):",
        f"  {'phase':<10} {'count':>7} {'p50_ms':>9} {'p99_ms':>9} "
        f"{'total_s':>9}",
    ]
    for r in phase_stats(traces):
        lines.append(
            f"  {r['phase']:<10} {r['count']:>7} {r['p50_ms']:>9.1f} "
            f"{r['p99_ms']:>9.1f} {r['total_s']:>9.2f}"
        )
    lat = latency_stats(traces)
    lines += [
        "",
        "request latency (from spans):",
        f"  {'':<6} {'count':>7} {'p50_ms':>9} {'p99_ms':>9}",
    ]
    for key in ("ttft", "itl", "e2e"):
        r = lat[key]
        lines.append(
            f"  {key:<6} {r['count']:>7} {r['p50_ms']:>9.1f} "
            f"{r['p99_ms']:>9.1f}"
        )
    slow = sorted(traces.values(), key=lambda t: -t.e2e_s)[:top]
    if slow:
        lines += ["", f"top {len(slow)} slowest trace(s):"]
        for tr in slow:
            req = tr.first("request") or {}
            hand = tr.first("handoff")
            lines.append(
                f"  {tr.trace_id}  e2e={tr.e2e_s * 1e3:.1f}ms  "
                f"tenant={tr.tenant or '-'}  "
                f"tokens={req.get('tokens', '-')}  "
                f"ttft={float(req.get('ttft_s', 0.0)) * 1e3:.1f}ms"
                + (
                    f"  handoff={hand.get('outcome', '?')}"
                    if hand is not None else ""
                )
            )
    rollup = tenant_rollup(traces)
    if rollup:
        lines += [
            "",
            "per-tenant rollup:",
            f"  {'tenant':<12} {'traces':>7} {'tokens':>8} "
            f"{'e2e_p50_ms':>11} {'e2e_p99_ms':>11}",
        ]
        for r in rollup:
            lines.append(
                f"  {r['tenant']:<12} {r['traces']:>7} {r['tokens']:>8} "
                f"{r['e2e_p50_ms']:>11.1f} {r['e2e_p99_ms']:>11.1f}"
            )
    return "\n".join(lines)


def trace_json(events, trace_id: str) -> dict:
    """One trace as machine-readable JSON (``trace-report --json --trace``):
    the raw spans plus the derived tree facts a script would recompute."""
    tr = build_traces(events).get(trace_id)
    if tr is None:
        return {"trace_id": trace_id, "found": False, "spans": []}
    root = tr.root
    return {
        "trace_id": trace_id,
        "found": True,
        "e2e_ms": tr.e2e_s * 1e3,
        "tenant": tr.tenant,
        "root_span": None if root is None else root["span"],
        "orphans": len(tr.orphans()),
        "spans": sorted(tr.spans, key=lambda e: e.get("ts", 0.0)),
    }


def report_json(events, top: int = 5) -> dict:
    """The same report as machine-readable JSON (``trace-report --json``)."""
    traces = build_traces(events)
    slow = sorted(traces.values(), key=lambda t: -t.e2e_s)[:top]
    return {
        "events": len(events),
        "traces": len(traces),
        "phases": phase_stats(traces),
        "latency": latency_stats(traces),
        "slowest": [
            {
                "trace_id": t.trace_id,
                "e2e_ms": t.e2e_s * 1e3,
                "tenant": t.tenant,
                "orphans": len(t.orphans()),
            }
            for t in slow
        ],
        "tenants": tenant_rollup(traces),
    }


# ---------------------------------------------------------------------------
# step-report: offline rendering of obs/stepline captures and ring tails
# ---------------------------------------------------------------------------


def _tagged_steps(records, src: str) -> List[dict]:
    """StepRecord dicts from ``records``, each tagged with its source."""
    out = []
    for s in records:
        if isinstance(s, dict) and "wall_s" in s:
            s = dict(s)
            s.setdefault("src", src)
            out.append(s)
    return out


def extract_steps(data, src: str = "-") -> List[dict]:
    """Pull StepRecord dicts out of any of the shapes the profiler ships:
    a raw record list, one ``/profilez`` capture bundle, the dp fan-out
    (``{"r<d>": bundle}``), a ``/debugz`` bundle (``recent_steps``), or
    the providerless ``/profilez`` view (``profilers``)."""
    if isinstance(data, list):
        return _tagged_steps(data, src)
    if not isinstance(data, dict):
        return []
    if isinstance(data.get("steps"), list):  # one capture bundle
        return _tagged_steps(data["steps"], str(data.get("profiler", src)))
    out: List[dict] = []
    for key in ("recent_steps", "profilers"):
        if isinstance(data.get(key), list):  # /debugz, bare /profilez
            for p in data[key]:
                if isinstance(p, dict):
                    out += _tagged_steps(
                        p.get("steps", []), str(p.get("profiler", src))
                    )
            return out
    for k, v in sorted(data.items()):  # dp fan-out {"r0": bundle, ...}
        if isinstance(v, dict) and isinstance(v.get("steps"), list):
            out += _tagged_steps(v["steps"], str(v.get("profiler", k)))
    return out


def load_steps(paths) -> List[dict]:
    """Read step records from JSON files (any supported shape), merged and
    sorted by timestamp. A file that fails to parse is skipped — the
    report must run on whatever a postmortem scraped."""
    steps: List[dict] = []
    for path in paths:
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        steps += extract_steps(data, path)
    steps.sort(key=lambda s: s.get("ts", 0.0))
    return steps


def step_phase_table(steps) -> List[dict]:
    """Per-phase host attribution over all steps, plus the ``blocked`` and
    ``unattributed`` pseudo-phases — one row each: count of steps the
    phase appeared in, p50/p99 per-step duration, total seconds, and the
    share of total step wall. Sorted by total descending."""
    wall_total = sum(float(s.get("wall_s", 0.0)) for s in steps) or 1.0
    buckets: Dict[str, List[float]] = {}
    for s in steps:
        for name, dur in (s.get("phases") or {}).items():
            buckets.setdefault(name, []).append(float(dur))
        for pseudo in ("blocked", "unattributed"):
            v = float(s.get(f"{pseudo}_s", 0.0))
            if v > 0:
                buckets.setdefault(pseudo, []).append(v)
    rows = []
    for name, vals in buckets.items():
        rows.append({
            "phase": name,
            "count": len(vals),
            "p50_ms": _pctile(vals, 0.50) * 1e3,
            "p99_ms": _pctile(vals, 0.99) * 1e3,
            "total_s": sum(vals),
            "wall_pct": 100.0 * sum(vals) / wall_total,
        })
    rows.sort(key=lambda r: -r["total_s"])
    return rows


def step_summary(steps) -> dict:
    """Aggregate view: step count, total wall, duration-weighted host
    occupancy / device-idle / blocked / unattributed fractions, tokens
    applied, and the worst single-step accounting residual (how far
    ``host + blocked + unattributed`` strays from ``wall`` — 0 by
    construction unless the input was hand-edited)."""
    wall = sum(float(s.get("wall_s", 0.0)) for s in steps)
    host = sum(float(s.get("host_s", 0.0)) for s in steps)
    blocked = sum(float(s.get("blocked_s", 0.0)) for s in steps)
    idle = sum(float(s.get("idle_s", 0.0)) for s in steps)
    unatt = sum(float(s.get("unattributed_s", 0.0)) for s in steps)
    walls = [float(s.get("wall_s", 0.0)) for s in steps]
    resid = max(
        (
            abs(
                float(s.get("wall_s", 0.0))
                - float(s.get("host_s", 0.0))
                - float(s.get("blocked_s", 0.0))
                - float(s.get("unattributed_s", 0.0))
            )
            for s in steps
        ),
        default=0.0,
    )
    return {
        "steps": len(steps),
        "wall_s": wall,
        "step_wall_p50_ms": _pctile(walls, 0.50) * 1e3,
        "step_wall_p99_ms": _pctile(walls, 0.99) * 1e3,
        "host_occupancy": host / wall if wall > 0 else 0.0,
        "blocked_frac": blocked / wall if wall > 0 else 0.0,
        "device_idle_frac": idle / wall if wall > 0 else 0.0,
        "unattributed_frac": unatt / wall if wall > 0 else 0.0,
        "tokens": sum(int(s.get("tokens", 0)) for s in steps),
        "max_accounting_residual_s": resid,
    }


def occupancy_timeline(steps, bins: int = 20) -> List[dict]:
    """Host occupancy over time: the (timestamp-sorted) steps split into up
    to ``bins`` contiguous groups, each reduced to its duration-weighted
    occupancy — the serial-loop scaling curve at a glance."""
    n = len(steps)
    if n == 0:
        return []
    bins = max(1, min(bins, n))
    out = []
    for b in range(bins):
        lo, hi = (n * b) // bins, (n * (b + 1)) // bins
        group = steps[lo:hi]
        if not group:
            continue
        wall = sum(float(s.get("wall_s", 0.0)) for s in group)
        host = sum(float(s.get("host_s", 0.0)) for s in group)
        out.append({
            "steps": len(group),
            "rows_max": max(int(s.get("rows", 0)) for s in group),
            "occupancy": host / wall if wall > 0 else 0.0,
        })
    return out


def worst_bubbles(steps, top: int = 5) -> List[dict]:
    """The steps with the largest device-idle bubbles, worst first."""
    ranked = sorted(
        (s for s in steps if float(s.get("idle_s", 0.0)) > 0),
        key=lambda s: -float(s["idle_s"]),
    )
    return ranked[:top]


def render_step_report(steps, top: int = 5) -> str:
    """The step-report text: summary, per-phase attribution, occupancy
    over time, worst bubbles."""
    if not steps:
        return "no step records in the input"
    s = step_summary(steps)
    lines = [
        f"{s['steps']} step(s), {s['wall_s']:.3f}s wall, "
        f"{s['tokens']} token(s)",
        f"  host_occupancy={s['host_occupancy']:.3f}  "
        f"blocked={s['blocked_frac']:.3f}  "
        f"device_idle={s['device_idle_frac']:.3f}  "
        f"unattributed={s['unattributed_frac']:.3f}",
        f"  step_wall p50={s['step_wall_p50_ms']:.2f}ms "
        f"p99={s['step_wall_p99_ms']:.2f}ms",
        "",
        "per-phase host attribution:",
        f"  {'phase':<14} {'count':>7} {'p50_ms':>9} {'p99_ms':>9} "
        f"{'total_s':>9} {'wall%':>7}",
    ]
    for r in step_phase_table(steps):
        lines.append(
            f"  {r['phase']:<14} {r['count']:>7} {r['p50_ms']:>9.2f} "
            f"{r['p99_ms']:>9.2f} {r['total_s']:>9.3f} "
            f"{r['wall_pct']:>6.1f}%"
        )
    timeline = occupancy_timeline(steps)
    if len(timeline) > 1:
        lines += ["", "host occupancy over time (oldest first):"]
        for i, b in enumerate(timeline):
            bar = "#" * int(round(b["occupancy"] * 40))
            lines.append(
                f"  [{i:>3}] occ={b['occupancy']:.3f} "
                f"rows<={b['rows_max']:<4} |{bar:<40}|"
            )
    bubbles = worst_bubbles(steps, top)
    if bubbles:
        lines += ["", f"top {len(bubbles)} device-idle bubble step(s):"]
        for b in bubbles:
            lines.append(
                f"  src={b.get('src', '-')} idle={b['idle_s'] * 1e3:.2f}ms "
                f"wall={float(b.get('wall_s', 0.0)) * 1e3:.2f}ms "
                f"rows={b.get('rows', 0)} tokens={b.get('tokens', 0)}"
            )
    return "\n".join(lines)


def step_report_json(steps, top: int = 5) -> dict:
    """The same step report as machine-readable JSON
    (``step-report --json``)."""
    return {
        "summary": step_summary(steps),
        "phases": step_phase_table(steps),
        "timeline": occupancy_timeline(steps),
        "worst_bubbles": worst_bubbles(steps, top),
    }
