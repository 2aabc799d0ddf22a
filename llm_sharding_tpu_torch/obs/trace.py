"""Request-centric tracing: span events, context propagation, the
in-memory flight recorder and the rotating JSONL writer. The port's own
copy of ``llm_sharding_tpu/obs/trace.py`` (whole); the span schema is the
same, so one ``trace-report`` merges the two packages' trace files.

A ``TraceContext`` (``trace_id`` + span ids) is born at ``submit()`` (or
is a child of the context a caller passes), rides the ``Request`` through
snapshots and ``extract`` / ``adopt`` migration, and every stage emits a
CHILD span, so merging the JSONL files by ``trace_id`` rebuilds one tree
per request (``python -m llm_sharding_tpu_torch trace-report``).

Schema (one JSON object per line / ring entry):

    {"ts": <unix seconds, float>,   # event END time
     "span": "<name>",              # see the README's port section
     "dur_s": <float>,              # span duration (absent for point events)
     "src": "<emitter>",            # s0 for a server
     "trace_id": "<hex>",           # request attribution (absent on
     "span_id": "<hex>",            #  per-step loop spans)
     "parent": "<hex>",
     ...span-specific fields}

Span names the port's server emits: ``request`` (submission→finish; the
per-request root), ``radix`` (prefix-cache match at admission),
``prefill`` (per request) and ``admit`` (per admission batch),
``decode`` (bucketed committed-token runs), ``chunk`` / ``apply`` (step
phases, uncorrelated) and ``extract`` / ``adopt`` (live migration).

Every span ALSO lands in the process-wide ``FLIGHT_RECORDER``, a bounded
ring of recent spans served by ``/debugz`` (obs/http.py), so a postmortem
bundle exists even when no ``trace_path`` was configured. Recording is one
dict and a deque append under a lock, and can be switched off for an A/B
measurement with ``FLIGHT_RECORDER.set_enabled(False)``.

Writes are line-buffered and serialized per writer, a full line per
``write`` call. ``TraceWriter`` rotates at ``max_bytes`` (the current file
renamed to ``<path>.1``, replacing any previous rollover), so a long-lived
server cannot fill the disk.
"""

from __future__ import annotations

import collections
import json
import os
import re
import time

from ..analysis.lockorder import named_lock
from typing import Optional

#: Rollover threshold for ``TraceWriter`` (bytes). At ~150 B/span this keeps
#: roughly the last 400k spans on disk (current file + one rollover).
DEFAULT_TRACE_MAX_BYTES = 64 * 1024 * 1024

_ID_RE = re.compile(r"^[A-Za-z0-9_.\-]{1,128}$")


def _gen_id() -> str:
    """16 hex chars of OS randomness — cheap (~1 µs), collision-safe at any
    realistic request rate, and stable across processes (no counter to
    collide when replicas generate ids independently)."""
    return os.urandom(8).hex()


def valid_trace_id(tid) -> bool:
    """Whether a caller-supplied id (the ``X-Trace-Id`` header) is safe to
    honor: short, printable, no whitespace/quotes — anything else is
    replaced with a generated id rather than poisoning the JSONL."""
    return isinstance(tid, str) and bool(_ID_RE.match(tid))


class TraceContext:
    """One request's position in a trace tree: the shared ``trace_id``, this
    request's own ``span_id`` (children parent to it) and the ``parent_id``
    it answers to (the ingress root span for HTTP traffic; None for direct
    API submits). Immutable in practice — migration moves the ``Request``
    object itself, so the context rides along untouched."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id

    @classmethod
    def new(cls, trace_id: Optional[str] = None) -> "TraceContext":
        """A fresh ROOT context: new trace (or the caller's validated
        ``trace_id``), new span id, no parent."""
        if trace_id is None or not valid_trace_id(trace_id):
            trace_id = _gen_id()
        return cls(trace_id, _gen_id(), None)

    def child(self) -> "TraceContext":
        """A child context in the same trace, parented to this span."""
        return TraceContext(self.trace_id, _gen_id(), self.span_id)

    def to_json(self) -> list:
        return [self.trace_id, self.span_id, self.parent_id]

    @classmethod
    def from_json(cls, data) -> Optional["TraceContext"]:
        if not data:
            return None
        tid, sid, pid = data
        return cls(str(tid), str(sid), None if pid is None else str(pid))

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return (
            f"TraceContext(trace_id={self.trace_id!r}, "
            f"span_id={self.span_id!r}, parent_id={self.parent_id!r})"
        )


class SpanRing:
    """Bounded in-memory ring of recent span events — the flight recorder.
    Thread-safe; ``snapshot()`` returns the events oldest-first. Disabling
    (``set_enabled(False)``) makes ``append`` a no-op for overhead A/B runs
    (``FLIGHT_RECORDER.set_enabled(False)`` in an overhead measurement)."""

    def __init__(self, capacity: int = 4096):
        self._lock = named_lock("obs.trace.ring")
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._enabled = True

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, on: bool) -> None:
        self._enabled = bool(on)

    def append(self, ev: dict) -> None:
        if not self._enabled:
            return
        with self._lock:
            self._ring.append(ev)

    def snapshot(self) -> list:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


#: The process-wide flight recorder every ``emit_span`` feeds; ``/debugz``
#: serves its snapshot. One ring for the process (spans carry ``src`` for
#: per-server attribution) — dp replicas share it like the load gauges.
FLIGHT_RECORDER = SpanRing()


class TraceWriter:
    """Append-only JSONL span writer; thread-safe; ``close()`` idempotent
    (emit-after-close is a no-op). Rotates at ``max_bytes``: the current
    file is renamed to ``<path>.1`` (replacing any previous rollover) and a
    fresh file opened, so a long-lived daemon's trace is bounded at roughly
    ``2 × max_bytes`` on disk."""

    def __init__(self, path: str, max_bytes: int = DEFAULT_TRACE_MAX_BYTES):
        self.path = path
        self.max_bytes = int(max_bytes)
        self._lock = named_lock("obs.trace.writer")
        self._f = open(path, "a", buffering=1)
        try:
            self._written = os.fstat(self._f.fileno()).st_size
        except OSError:
            self._written = 0

    def emit(self, span: str, dur_s: Optional[float] = None, **fields):
        ev = {"ts": time.time(), "span": span}
        if dur_s is not None:
            ev["dur_s"] = round(float(dur_s), 6)
        ev.update(fields)
        self.write_event(ev)

    def write_event(self, ev: dict) -> None:
        line = json.dumps(ev, sort_keys=True) + "\n"
        with self._lock:
            if self._f is None:
                return
            if (
                self.max_bytes > 0
                and self._written + len(line) > self.max_bytes
                and self._written > 0
            ):
                self._rotate()
            self._f.write(line)
            self._written += len(line)

    def _rotate(self) -> None:
        """Size-capped rollover (held under ``_lock``): close, rename the
        full file to ``<path>.1`` (os.replace — the previous rollover is
        overwritten) and reopen fresh. A rename failure (e.g. a sibling
        process holding the file on a quirky filesystem) truncates in place
        instead — the bound on disk use holds either way."""
        self._f.close()
        try:
            os.replace(self.path, f"{self.path}.1")
            self._f = open(self.path, "a", buffering=1)
        except OSError:
            self._f = open(self.path, "w", buffering=1)
        self._written = 0

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


def emit_span(
    writer: Optional[TraceWriter],
    span: str,
    dur_s: Optional[float] = None,
    trace: Optional[TraceContext] = None,
    parent_of: Optional[TraceContext] = None,
    **fields,
):
    """Emit one span event to the flight recorder AND ``writer`` (if any).

    ``trace`` stamps the event as the context's OWN span (trace_id +
    span_id + parent) — used for the ``ingress``/``request`` tree nodes.
    ``parent_of`` stamps it as a CHILD of the context (trace_id + parent =
    the context's span_id) — the common case for per-stage leaf spans.
    Process-level decision spans pass neither."""
    ev: dict = {"ts": time.time(), "span": span}
    if dur_s is not None:
        ev["dur_s"] = round(float(dur_s), 6)
    if trace is not None:
        ev["trace_id"] = trace.trace_id
        ev["span_id"] = trace.span_id
        if trace.parent_id is not None:
            ev["parent"] = trace.parent_id
    elif parent_of is not None:
        ev["trace_id"] = parent_of.trace_id
        ev["parent"] = parent_of.span_id
    ev.update(fields)
    FLIGHT_RECORDER.append(ev)
    if writer is not None:
        writer.write_event(ev)
    return ev
