"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.
The port's own copy of ``llm_sharding_tpu/obs/metrics.py:52-565`` (the
registry core and the paged-KV / prefix-cache gauges the server's load
sweep feeds): that module is stdlib only, but importing it pulls jax in
through ``llm_sharding_tpu/obs/__init__.py``. Its locks are built by the
port's ``analysis.lockorder.named_lock`` under the JAX names
(``obs.metrics.*``). The families of the port's layers follow: the
attention paths and the blocks they read (decode backend, prefill path,
admission buckets, batched cancels), the ingress, the fleet (cluster
index, replica supervision and roles, disagg hand-offs, autoscale). Those
of later slices (jit shape keys, context-parallel streams) stay with those
slices.

One ``Registry`` holds every metric family; families are labeled
(Prometheus-style), children are created on first use, and every mutation
is lock-protected so concurrent request/pump threads sum exactly. Two
read-out formats:

- ``prometheus_text()`` — the text exposition format;
- ``json_snapshot()`` — a JSON-friendly dict with histogram quantiles
  (p50/p90/p99, linear interpolation within the fixed buckets).

The port's registry and the JAX package's are separate objects: a process
that imports both (the parity tests) holds two tallies of the same names.
"""

from __future__ import annotations

import json
import math
import re
import time
from typing import Dict, Optional, Sequence, Tuple

from ..analysis.lockorder import named_lock


_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Latency buckets (seconds): sub-ms host work through minute-scale compiles.
DEFAULT_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)
# Throughput buckets (tokens/sec): CPU-smoke single digits to chip thousands.
DEFAULT_RATE_BUCKETS = (
    1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
    1000.0, 2000.0, 5000.0, 10000.0,
)

#: How long a bucket's exemplar stays "fresh": within the TTL only a larger
#: observation replaces it (bucket-max semantics — the slowest recent
#: request wins); past it any new observation does (recency semantics — a
#: p99 spike from an hour ago must not shadow today's).
EXEMPLAR_TTL_S = 60.0


def _fmt(v: float) -> str:
    """Prometheus sample value: integers render without the trailing .0.
    Non-finite values (an inf/NaN observation poisons a histogram sum
    forever) render as Prometheus spellings instead of crashing the scrape
    — isfinite must be checked BEFORE floor (floor raises on inf/NaN)."""
    f = float(v)
    if not math.isfinite(f):
        return "+Inf" if f > 0 else ("-Inf" if f < 0 else "NaN")
    if f == math.floor(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _exemplar_str(ex) -> str:
    """OpenMetrics exemplar suffix for one bucket line ('' when absent)."""
    if ex is None:
        return ""
    tid, v, ts = ex
    return (
        f' # {{trace_id="{_escape_label(tid)}"}} {_fmt(v)} {repr(float(ts))}'
    )


def _label_str(names: Tuple[str, ...], values: Tuple[str, ...]) -> str:
    if not names:
        return ""
    inner = ",".join(
        f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)
    )
    return "{" + inner + "}"


class _CounterChild:
    __slots__ = ("_lock", "_value")

    def __init__(self, lock):
        self._lock = lock  # shardlint: lock obs.metrics.family
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counters only go up (inc by {n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _GaugeChild:
    __slots__ = ("_lock", "_value")

    def __init__(self, lock):
        self._lock = lock  # shardlint: lock obs.metrics.family
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _HistogramChild:
    __slots__ = ("_lock", "bounds", "counts", "sum", "count", "exemplars")

    def __init__(self, lock, bounds: Tuple[float, ...]):
        self._lock = lock  # shardlint: lock obs.metrics.family
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0
        # per-bucket slow-request exemplar: index -> (trace_id, value, ts).
        # Sparse (most buckets never see a traced observation); see
        # EXEMPLAR_TTL_S for the replacement policy.
        self.exemplars: Dict[int, Tuple[str, float, float]] = {}

    def observe(self, v: float, trace_id: Optional[str] = None) -> None:
        v = float(v)
        with self._lock:
            i = 0
            for i, b in enumerate(self.bounds):  # noqa: B007
                if v <= b:
                    break
            else:
                i = len(self.bounds)
            self.counts[i] += 1
            self.sum += v
            self.count += 1
            if trace_id is not None:
                cur = self.exemplars.get(i)
                now = time.time()
                if (
                    cur is None or v >= cur[1]
                    or now - cur[2] > EXEMPLAR_TTL_S
                ):
                    self.exemplars[i] = (str(trace_id), v, now)

    def snap(self):
        """Atomic (counts, sum, count) copy — exposition must read under the
        same lock observe() writes under, or a concurrent scrape can emit a
        count that disagrees with its own sum/buckets."""
        with self._lock:
            return list(self.counts), self.sum, self.count

    def snap_exemplars(self) -> Dict[int, Tuple[str, float, float]]:
        with self._lock:
            return dict(self.exemplars)

    def quantile(self, q: float) -> Optional[float]:
        """Estimated q-quantile (0 < q <= 1) by linear interpolation within
        the fixed buckets — the standard Prometheus ``histogram_quantile``
        estimate, computed host-side. ``None`` with no observations; samples
        landing in the +Inf bucket clamp to the largest finite bound."""
        counts, _, total = self.snap()
        return _quantile_from(self.bounds, counts, total, q)


def _quantile_from(bounds, counts, total, q: float) -> Optional[float]:
    if total == 0:
        return None
    rank = q * total
    cum = 0
    for i, c in enumerate(counts):
        prev = cum
        cum += c
        if cum >= rank and c > 0:
            if i >= len(bounds):
                return bounds[-1] if bounds else None
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i]
            return lo + (hi - lo) * (rank - prev) / c
    return bounds[-1] if bounds else None


_CHILD_TYPES = {
    "counter": _CounterChild,
    "gauge": _GaugeChild,
    "histogram": _HistogramChild,
}


class _Family:
    """One named metric family; labeled children created on first use.
    Unlabeled families proxy ``inc/set/dec/observe/value`` straight to their
    single child so call sites stay terse."""

    def __init__(
        self,
        kind: str,
        name: str,
        help: str,
        label_names: Tuple[str, ...],
        buckets: Optional[Tuple[float, ...]] = None,
    ):
        self.kind = kind
        self.name = name
        self.help = help
        self.label_names = label_names
        self.buckets = buckets
        self._lock = named_lock("obs.metrics.family")
        self._children: Dict[Tuple[str, ...], object] = {}
        if not label_names:
            self._children[()] = self._make_child()

    def _make_child(self):
        if self.kind == "histogram":
            return _HistogramChild(self._lock, self.buckets)
        return _CHILD_TYPES[self.kind](self._lock)

    def labels(self, *values, **kw):
        if kw:
            if values:
                raise ValueError("pass label values positionally OR by name")
            values = tuple(str(kw[n]) for n in self.label_names)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name} takes labels {self.label_names}, got {values}"
            )
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = self._make_child()
            return child

    # unlabeled convenience proxies ------------------------------------
    def _solo(self):
        if self.label_names:
            raise ValueError(f"{self.name} is labeled: use .labels(...)")
        return self._children[()]

    def inc(self, n: float = 1.0) -> None:
        self._solo().inc(n)

    def set(self, v: float) -> None:
        self._solo().set(v)

    def dec(self, n: float = 1.0) -> None:
        self._solo().dec(n)

    def observe(self, v: float, trace_id: Optional[str] = None) -> None:
        self._solo().observe(v, trace_id=trace_id)

    @property
    def value(self) -> float:
        return self._solo().value

    def series(self):
        with self._lock:
            return sorted(self._children.items())


class StateGauge:
    """A one-hot state machine over a labeled gauge family: exactly one
    ``state`` label holds 1.0 at any time (the Prometheus idiom for enum
    state — ``server_health_state{state="SERVING"} 1`` — scrapers alert on
    ``{state="DEGRADED"} == 1`` without string parsing). ``set_state``
    serializes writers under its own lock, so concurrent transitions can
    never interleave into two states at 1; a scrape can at worst observe
    the one-hot mid-flip, never a stale extra state left behind."""

    __slots__ = ("_family", "states", "_state", "_set_lock")

    def __init__(self, family: "_Family", states: Tuple[str, ...]):
        self._family = family
        self.states = states
        self._state: Optional[str] = None
        self._set_lock = named_lock("obs.metrics.stategauge")
        for s in states:  # materialize every label so scrapes see the 0s
            family.labels(state=s).set(0.0)

    def set_state(self, state: str) -> None:
        if state not in self.states:
            raise ValueError(
                f"unknown state {state!r}; expected one of {self.states}"
            )
        with self._set_lock:
            for s in self.states:
                self._family.labels(state=s).set(1.0 if s == state else 0.0)
            self._state = state

    @property
    def state(self) -> Optional[str]:
        return self._state


class Registry:
    """Thread-safe named collection of metric families. Registration is
    get-or-create: re-registering the same (name, kind, labels) returns the
    existing family (module reloads and multiple servers share one tally);
    a conflicting re-registration raises."""

    def __init__(self):
        self._lock = named_lock("obs.metrics.registry")
        self._families: Dict[str, _Family] = {}

    def _register(self, kind, name, help, labels, buckets=None) -> _Family:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        labels = tuple(labels)
        for ln in labels:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.label_names != labels or (
                    kind == "histogram" and fam.buckets != buckets
                ):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.label_names}"
                    )
                return fam
            fam = _Family(kind, name, help, labels, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "", labels: Sequence[str] = ()):
        return self._register("counter", name, help, labels)

    def gauge(self, name: str, help: str = "", labels: Sequence[str] = ()):
        return self._register("gauge", name, help, labels)

    def histogram(
        self,
        name: str,
        help: str = "",
        labels: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
    ):
        buckets = tuple(sorted(float(b) for b in buckets))
        if not buckets:
            raise ValueError("histogram needs at least one finite bucket")
        return self._register("histogram", name, help, labels, buckets)

    def state_gauge(
        self, name: str, help: str = "", states: Sequence[str] = ()
    ) -> StateGauge:
        """A one-hot enum gauge (see ``StateGauge``), labeled ``state``."""
        if not states:
            raise ValueError("state_gauge needs at least one state")
        return StateGauge(
            self._register("gauge", name, help, ("state",)), tuple(states)
        )

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def _sorted_families(self):
        with self._lock:
            return sorted(self._families.items())

    # ------------------------------------------------------------- readout

    def prometheus_text(self, openmetrics: bool = False) -> str:
        """Text exposition. Default: pure Prometheus text format 0.0.4 —
        NO exemplars, because 0.0.4 allows only an optional timestamp after
        the sample value and a strict parser fails the whole scrape on
        anything more. ``openmetrics=True`` emits the OpenMetrics flavor
        instead (what a scraper negotiates via ``Accept:
        application/openmetrics-text`` — the standard channel for
        exemplars): slow-request exemplars ride the histogram bucket lines
        (``… # {trace_id="…"} v ts``), counter metadata drops the
        ``_total`` suffix as the spec requires, and the body terminates
        with ``# EOF``."""
        out = []
        for name, fam in self._sorted_families():
            meta_name = (
                name[: -len("_total")]
                if openmetrics and fam.kind == "counter"
                and name.endswith("_total") else name
            )
            if fam.help:
                out.append(f"# HELP {meta_name} {fam.help}")
            out.append(f"# TYPE {meta_name} {fam.kind}")
            for values, child in fam.series():
                ls = _label_str(fam.label_names, values)
                if fam.kind == "histogram":
                    counts, total_sum, _ = child.snap()
                    exem = (
                        child.snap_exemplars() if openmetrics else {}
                    )
                    cum = 0
                    for i, (b, c) in enumerate(zip(fam.buckets, counts)):
                        cum += c
                        le = _label_str(
                            fam.label_names + ("le",), values + (_fmt(b),)
                        )
                        out.append(
                            f"{name}_bucket{le} {cum}"
                            + _exemplar_str(exem.get(i))
                        )
                    cum += counts[-1]
                    le = _label_str(
                        fam.label_names + ("le",), values + ("+Inf",)
                    )
                    out.append(
                        f"{name}_bucket{le} {cum}"
                        + _exemplar_str(exem.get(len(fam.buckets)))
                    )
                    out.append(f"{name}_sum{ls} {_fmt(total_sum)}")
                    out.append(f"{name}_count{ls} {cum}")
                else:
                    out.append(f"{name}{ls} {_fmt(child.value)}")
        if openmetrics:
            out.append("# EOF")
        return "\n".join(out) + "\n"

    def json_snapshot(self) -> dict:
        """JSON-friendly view: histograms carry count/sum/p50/p90/p99 and the
        per-bucket cumulative counts; counters/gauges carry the value."""
        snap: dict = {}
        for name, fam in self._sorted_families():
            series = []
            for values, child in fam.series():
                entry: dict = {"labels": dict(zip(fam.label_names, values))}
                if fam.kind == "histogram":
                    # one atomic snap feeds buckets, count, sum AND the
                    # quantiles — the whole entry is self-consistent
                    counts, total_sum, total = child.snap()
                    cum, buckets = 0, {}
                    for b, c in zip(fam.buckets, counts):
                        cum += c
                        buckets[_fmt(b)] = cum
                    buckets["+Inf"] = cum + counts[-1]
                    entry.update(
                        count=total,
                        sum=total_sum,
                        p50=_quantile_from(fam.buckets, counts, total, 0.50),
                        p90=_quantile_from(fam.buckets, counts, total, 0.90),
                        p99=_quantile_from(fam.buckets, counts, total, 0.99),
                        buckets=buckets,
                    )
                    exem = child.snap_exemplars()
                    if exem:
                        # keyed by bucket upper bound; a p99 spike on /statz
                        # links straight to its trace_id
                        entry["exemplars"] = {
                            (
                                _fmt(fam.buckets[i])
                                if i < len(fam.buckets) else "+Inf"
                            ): {
                                "trace_id": tid,
                                "value": v,
                                "ts": ts,
                            }
                            for i, (tid, v, ts) in sorted(exem.items())
                        }
                else:
                    entry["value"] = child.value
                series.append(entry)
            snap[name] = {"type": fam.kind, "help": fam.help, "series": series}
        return snap

    def json_text(self) -> str:
        return json.dumps(self.json_snapshot(), sort_keys=True)


#: The process-wide default registry every subsystem records into. Tests
#: that need isolation construct their own ``Registry``.
REGISTRY = Registry()


# -- paged KV memory (runtime/blocks.py + runtime/server.py) ----------------
# Defined here (not in the server module) so the three gauges exist — and
# show 0 — on /statz and the :stats control line even before the first
# paged server is constructed; the server's load-gauge sweep keeps them
# current, summed over live paged servers like server_queue_depth.
KV_BLOCKS_TOTAL = REGISTRY.gauge(
    "server_kv_blocks_total",
    "Allocatable KV arena blocks across live paged servers (the reserved "
    "trash block excluded)",
)
KV_BLOCKS_IN_USE = REGISTRY.gauge(
    "server_kv_blocks_in_use",
    "KV arena blocks currently held by live requests or shared prefixes",
)
ARENA_BYTES = REGISTRY.gauge(
    "server_arena_bytes",
    "Device bytes of the pooled KV arena across live paged servers, by "
    "storage dtype (K + V codes plus, for quantized int8/fp8 arenas, the "
    "per-block-per-head f32 scale arenas — computed via "
    "runtime/blocks.BlockAllocator.bytes_per_block, so HBM savings from "
    "--kv-dtype are observable, not just asserted)",
    labels=("dtype",),
)
KV_WASTE_FRAC = REGISTRY.gauge(
    "server_kv_waste_frac",
    "1 - live tokens / allocated token slots over the in-use blocks: the "
    "internal fragmentation of the paged KV pool (dense serving's "
    "equivalent figure is 1 - live/capacity per row). COLD prefix-cache "
    "blocks (radix-tree-held, no row mapping them) are excluded from the "
    "slot denominator — they are reusable capacity, not waste. Shared "
    "prefix tokens count once per mapping row, so heavy sharing can "
    "drive this to 0",
)

# -- automatic prefix cache (runtime/radix.py) ------------------------------
PREFIX_HIT_TOKENS = REGISTRY.counter(
    "server_prefix_cache_hit_tokens_total",
    "Prompt tokens served from the radix prefix cache instead of being "
    "prefilled (summed over admissions on live servers), by the tier the "
    "tokens lived in when the match was taken: hbm = already arena-"
    "resident, host = streamed back from the pinned host pool, disk = "
    "promoted from the memory-mapped disk pool. The saved prefill FLOPs "
    "scale with the sum",
    labels=("tier",),
)
PREFIX_HIT_RATE = REGISTRY.gauge(
    "server_prefix_cache_hit_rate",
    "Cumulative prefix-cache hit rate over live servers: cache-served "
    "prompt tokens / cache-eligible prompt tokens (requests without an "
    "explicit PrefixHandle or embeddings entry). 0 with the cache off "
    "or no eligible traffic yet",
)
KV_HOST_TIER_BLOCKS = REGISTRY.gauge(
    "server_kv_host_tier_blocks",
    "Prefix-cache blocks currently demoted to the pinned host-RAM pool "
    "across live servers (streamed back to HBM on a later radix hit)",
)
KV_DISK_TIER_BLOCKS = REGISTRY.gauge(
    "server_kv_disk_tier_blocks",
    "Prefix-cache blocks currently spilled to the bounded on-disk pool "
    "across live servers (memory-mapped entry files; promoted "
    "disk→host→arena on a later radix hit, and the pool survives "
    "restarts)",
)
GLOBAL_INDEX_ENTRIES = REGISTRY.gauge(
    "server_global_index_entries",
    "Live {prefix-hash, replica} entries in the cluster-global radix "
    "index — the map replicas publish their tree contents into and the "
    "fleet router consults before placing a request (deepest match "
    "first, then warmest tier)",
)


# -- attention paths (runtime/server.py, parallel/serve.py) -----------------
# The JAX names, kinds, labels and help (JAX ``obs/metrics.py:567-627``,
# ``parallel/serve.py:64`` and ``:514``). The port's label values: backend
# ``kernel`` = the CUDA paged kernel, ``xla`` = the plain
# ``paged_attention_xla`` path, ``dense`` = dense serving (``interpret``
# stays 0: the port has no emulated kernel); prefill path ``kernel`` /
# ``xla`` likewise, ``gather`` = dense. The block counters are host-side
# estimates from the length mirrors, as in JAX: nothing reads the device.

#: Decode-attention implementations a live server can run
#: (``ops/paged_attention`` dispatch; "dense" = non-paged serving,
#: "interpret" = the Pallas kernel emulated off-TPU via
#: PAGED_FORCE_KERNEL).
ATTN_BACKENDS = ("kernel", "interpret", "xla", "dense")
ATTN_BACKEND = REGISTRY.gauge(
    "server_attn_backend",
    "Live servers by resolved decode-attention backend: kernel = the "
    "Pallas paged kernel streaming only each row's mapped arena blocks, "
    "xla = the exact gather fallback, interpret = the kernel emulated "
    "off-TPU, dense = non-paged serving. One-hot over the labels for a "
    "single-server process; a count per backend otherwise",
    labels=("backend",),
)
ATTN_BLOCKS_READ = REGISTRY.counter(
    "server_attn_blocks_read_total",
    "KV arena blocks attended by paged decode steps, summed over live "
    "rows and ring cycles (host-side estimate from the length mirrors: "
    "ceil(len / block_size) per row per decode/verify step). Multiply by "
    "block_size x Nkv x Dh x 2 x dtype bytes x layers for an "
    "attention-bytes-per-step estimate; the dense equivalent reads "
    "capacity slots per row regardless of length",
)

#: Chunked-prefill implementations a dispatch can take: ``kernel`` = the
#: chunked-prefill kernel over the arena, ``xla`` = the plain gather path
#: over the arena, ``gather`` = the dense full-window path (non-paged
#: serving).
PREFILL_PATHS = ("kernel", "xla", "gather")
PREFILL_PATH = REGISTRY.gauge(
    "server_prefill_path",
    "Chunked-prefill attention path of the most recent chunk dispatch, "
    "one-hot over {kernel, xla, gather}: kernel = the Pallas "
    "chunked-prefill kernel streaming table-named arena blocks "
    "(interpret-emulated off-TPU counts as kernel), xla = the arena "
    "gather inside the op (exact fallback), gather = dense (non-paged) "
    "full-window prefill",
    labels=("path",),
)
PREFILL_BLOCKS_READ = REGISTRY.counter(
    "server_prefill_blocks_read_total",
    "KV arena blocks attended by chunked-prefill dispatches, summed over "
    "admitting rows per chunk (host-side: ceil((prefix_offset + "
    "chunk_end) / block_size) per row — the written frontier each "
    "chunk's queries attend). Multiply by block bytes x layers for a "
    "prefill-attention-HBM estimate; the retired gather path moved the "
    "row's WHOLE mapped window in AND out per chunk on top of this",
)


def set_prefill_path(path: str) -> None:
    """One-hot flip of ``server_prefill_path`` (the chunk-dispatch-site
    analogue of the ``server_attn_backend`` sweep)."""
    if path not in PREFILL_PATHS:
        raise ValueError(f"unknown prefill path {path!r}; expected one of {PREFILL_PATHS}")
    for p in PREFILL_PATHS:
        PREFILL_PATH.labels(path=p).set(1.0 if p == path else 0.0)


# Admission-bucket usage, labeled by the padded prompt bucket: which rungs
# of the bucket ladder carry traffic (JAX ``parallel/serve.py:64``).
ADMIT_BUCKET_USED = REGISTRY.counter(
    "server_admit_bucket_total",
    "Admissions per prompt bucket (one compiled serve_admit shape each)",
    labels=("bucket",),
)
# Rows stopped per ``serve_cancel_rows`` call: a cancel, a deadline sweep or
# a containment batches every row it stops into one call (JAX
# ``parallel/serve.py:514``).
CANCEL_BATCH_ROWS = REGISTRY.histogram(
    "server_cancel_batch_rows",
    "Rows stopped per batched serve_cancel_rows dispatch (cancel, deadline "
    "sweep, failure containment)",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
)


# -- replica supervision (runtime/replicated.py) ----------------------------
# The JAX names, kinds, labels and help (JAX ``obs/metrics.py:634-685``): the
# families exist, and show 0 / no series, before the first ReplicatedServer.
REPLICA_FAILOVERS = REGISTRY.counter(
    "server_replica_failovers_total",
    "Replicas the router classified as FAILED (step raised, or containment "
    "events crossed the failure threshold inside the window) and failed "
    "over: quarantined, live requests migrated to survivors, then closed",
)
REPLICA_DRAINS = REGISTRY.counter(
    "server_replica_drains_total",
    "Elective replica drains (stop admitting, migrate every live request "
    "out, close): the scale-down half of dp elasticity",
)
REPLICA_SPAWNS = REGISTRY.counter(
    "server_replica_spawns_total",
    "Replicas spawned onto a freed device group (weights re-staged from "
    "the shared host arrays): the scale-up half of dp elasticity",
)
REQUESTS_MIGRATED = REGISTRY.counter(
    "server_requests_migrated_total",
    "Live requests moved between replicas during failover/drain, by "
    "outcome (ok = re-admitted on a survivor with its stream intact, "
    "failed = no survivor could adopt it — the request fails typed)",
    labels=("outcome",),
)

#: Router-level per-replica states: the three server health states, plus
#: QUARANTINED (classified failed; migration in progress) and OFFLINE (no
#: live replica on the device group — drained/failed-over, spawnable).
REPLICA_STATES = (
    "SERVING", "DEGRADED", "DRAINING", "QUARANTINED", "OFFLINE",
)
REPLICA_STATE = REGISTRY.gauge(
    "server_replica_state",
    "Per-replica supervision state, one-hot per replica label (the replica "
    "label is the device-group index, stable across drain/spawn cycles): "
    "exactly one state is 1 for each replica",
    labels=("replica", "state"),
)


def set_replica_state(replica, state: str) -> None:
    """One-hot flip of ``server_replica_state`` for one replica label (the
    per-replica analogue of ``StateGauge.set_state`` — a labeled StateGauge
    per replica would need dynamic registration; this keeps one family)."""
    if state not in REPLICA_STATES:
        raise ValueError(
            f"unknown replica state {state!r}; expected one of "
            f"{REPLICA_STATES}"
        )
    r = str(replica)
    for s in REPLICA_STATES:
        REPLICA_STATE.labels(replica=r, state=s).set(1.0 if s == state else 0.0)



# -- disaggregated prefill/decode serving (runtime/disagg.py) ---------------
# JAX ``obs/metrics.py:690-746``.
DISAGG_HANDOFFS = REGISTRY.counter(
    "server_disagg_handoffs_total",
    "Prefill→decode request hand-offs, by outcome (ok = KV blocks streamed "
    "and the decode replica resumed through the arena-gathered prefix — "
    "zero re-prefill FLOPs; cold = adopted without streamable KV (the "
    "decode side re-prefills, token-identically); retried = a transient "
    "kv_handoff fault deferred the hand-off one sweep; fallback = a "
    "permanent fault or refused adopt left the request decoding where the "
    "supervision layer could place it; no_target = no decode-capable "
    "replica live, the request keeps decoding on its prefill replica; "
    "failed = no replica could adopt the extracted request — it fails "
    "typed)",
    labels=("outcome",),
)
CP_STREAM_SHARDS = REGISTRY.counter(
    "server_cp_stream_shards_total",
    "Per-shard block-stream passes through a context-parallel paged arena "
    "(reads that gather blocks from their owner shard and writes that land "
    "blocks on the adopter's owner shard), by outcome (ok = the shard's "
    "slice moved; error = the pass raised — injected cp_shard_stream "
    "faults and real transfer failures both land here). Incremented only "
    "at cp>1; each snapshot, hand-off, host-tier demote/restore, or "
    "migration touches every owner shard of the rows it moves",
    labels=("outcome",),
)
HANDOFF_BYTES = REGISTRY.counter(
    "server_handoff_bytes_total",
    "Host bytes of KV block data streamed between replicas (prefill→decode "
    "hand-offs and cross-replica radix fills; quantized arenas stream "
    "codes + scales, so the figure reflects the wire cost, not the "
    "logical bf16 size)",
)
#: Replica roles in a disaggregated deployment: ``prefill`` replicas admit
#: fresh requests and hand their KV off after the first token, ``decode``
#: replicas resume them, ``unified`` replicas do both (the classic mode).
REPLICA_ROLES = ("prefill", "decode", "unified")
REPLICA_ROLE = REGISTRY.gauge(
    "server_replica_role",
    "Per-replica serving role, one-hot per replica label (the replica "
    "label is the device-group index): exactly one role is 1 for each "
    "replica of a disaggregated router; role assignment survives "
    "drain/spawn cycles on the group",
    labels=("replica", "role"),
)


def set_replica_role(replica, role: str) -> None:
    """One-hot flip of ``server_replica_role`` for one replica label (the
    role analogue of ``set_replica_state``)."""
    if role not in REPLICA_ROLES:
        raise ValueError(
            f"unknown replica role {role!r}; expected one of {REPLICA_ROLES}"
        )
    r = str(replica)
    for x in REPLICA_ROLES:
        REPLICA_ROLE.labels(replica=r, role=x).set(1.0 if x == role else 0.0)


DISAGG_TTFT_ERROR = REGISTRY.gauge(
    "server_disagg_ttft_error",
    "Relative |predicted − observed| / observed TTFT of the most recent "
    "planner-routed request: how well the profiler's fitted latency "
    "models track the live system (persistently high error means the "
    "profile.json was fitted on different hardware or load)",
)



# -- production ingress (runtime/ingress.py + runtime/fairness.py) ---------
# The JAX names, kinds, labels and buckets (JAX ``obs/metrics.py:760-810``):
# the families exist, and show 0, before the first IngressServer is built.
INGRESS_REQUESTS = REGISTRY.counter(
    "server_ingress_requests_total",
    "HTTP requests through the ingress, by tenant and outcome (ok = "
    "completed, rejected_rate / rejected_tenant_queue = per-tenant "
    "early shed with 429, rejected_overload / rejected_draining = global "
    "shed with 503, deadline = budget expired (shed in queue or "
    "mid-decode), disconnect = client went away mid-stream (row "
    "cancelled, KV freed), failed = backend containment or a shutdown "
    "that interrupted the stream (finish_reason \"cancelled\"), "
    "bad_request, unauthorized = no tenant matched the credentials "
    "(tenant label \"unknown\"), fault = injected http_request fault)",
    labels=("tenant", "outcome"),
)
INGRESS_ACTIVE = REGISTRY.gauge(
    "server_ingress_active_streams",
    "HTTP requests currently dispatched to the backend with a live "
    "client attached (queued-in-ingress requests are not active yet)",
)
INGRESS_QUEUED = REGISTRY.gauge(
    "server_ingress_queued",
    "Requests waiting in the ingress fair queue for backend dispatch, "
    "summed over tenants",
)
INGRESS_TTFT = REGISTRY.histogram(
    "server_ingress_ttft_seconds",
    "HTTP arrival to first committed token, by tenant (includes the "
    "fair-queue wait — the figure the flood-isolation chaos test bounds "
    "for the well-behaved tenant)",
    labels=("tenant",),
)
TENANT_QUEUED = REGISTRY.gauge(
    "server_tenant_queued",
    "Requests waiting in the ingress fair queue, per tenant",
    labels=("tenant",),
)
TENANT_SERVICE = REGISTRY.counter(
    "server_tenant_service_tokens_total",
    "Accumulated service per tenant in tokens, by kind (prefill = prompt "
    "tokens charged at backend dispatch, decode = committed tokens "
    "charged as they stream): the quantity the weighted fair queue "
    "schedules on",
    labels=("tenant", "kind"),
)
TENANT_THROTTLED = REGISTRY.counter(
    "server_tenant_throttled_total",
    "Per-tenant early sheds at the ingress door, by reason (rate = "
    "token-bucket limit, queue = per-tenant queued-work cap) — each one "
    "a 429 with Retry-After, never a queue-timeout death",
    labels=("tenant", "reason"),
)

# -- load-driven autoscaling (runtime/autoscale.py) -------------------------
# JAX ``obs/metrics.py:812-830``.
AUTOSCALE_SPAWNS = REGISTRY.counter(
    "server_autoscale_spawns_total",
    "Replica spawns initiated by the autoscaler (a subset of "
    "server_replica_spawns_total, which also counts :spawn and API calls)",
)
AUTOSCALE_DRAINS = REGISTRY.counter(
    "server_autoscale_drains_total",
    "Replica drains initiated by the autoscaler (a subset of "
    "server_replica_drains_total)",
)
AUTOSCALE_REPLICAS = REGISTRY.gauge(
    "server_autoscale_replicas",
    "Live replica count as of the autoscaler's last tick",
)
AUTOSCALE_LOAD = REGISTRY.gauge(
    "server_autoscale_load",
    "The load signal the autoscaler last evaluated: (backend queued + "
    "in-flight + ingress fair-queue depth) / live slot capacity — >1 "
    "means work is waiting that no live slot can take",
)


# -- pipeline placement (runtime/engine.py) ---------------------------------
# JAX ``runtime/engine.py:60-74``: every committed placement swap (an
# engine's construction included), its wall and the resulting stage count.
PLACEMENT_SWAPS = REGISTRY.counter(
    "engine_placement_swaps_total", "apply_placement calls that committed",
)
PLACEMENT_SWAP_SECONDS = REGISTRY.histogram(
    "engine_placement_swap_seconds",
    "Wall time of one placement swap (stage re-slice + device placement)",
)
PIPELINE_STAGES = REGISTRY.gauge(
    "engine_pipeline_stages", "Pipe-axis size of the engine's current mesh",
)
