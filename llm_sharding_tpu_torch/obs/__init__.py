"""Serving telemetry of the port (counterpart of ``llm_sharding_tpu/obs``),
all stdlib-only:

- ``metrics``  — thread-safe labeled counters/gauges/histograms with
  quantile readout, Prometheus text + JSON snapshot, and the process-wide
  ``REGISTRY`` the server records into;
- ``trace``    — request-centric tracing: ``TraceContext`` propagation,
  the rotating JSONL span writer behind the server's ``trace_path=`` knob,
  and the in-memory ``FLIGHT_RECORDER`` span ring;
- ``stepline`` — the continuous step profiler: one ``StepRecord`` per
  serve-loop step (disjoint host-phase durations, device-blocked wait,
  idle-bubble estimate) in a bounded ring, the derived
  ``server_host_occupancy`` / ``server_device_idle_frac`` gauges, the
  lock-wait metric sink, and the armable ``/profilez`` deep capture;
- ``http``     — ``MetricsServer``: a background stdlib-``http.server``
  thread serving ``/metrics``, ``/statz``, ``/debugz``, ``/profilez`` and
  ``/healthz``;
- ``report``   — the ``trace-report`` / ``step-report`` CLIs' span-tree
  reconstruction and per-phase latency/step attribution.

The JAX package's ``record_shape_key`` (jit shape keys) has no counterpart:
the port compiles no programs per shape.
"""

from .metrics import (  # noqa: F401
    DEFAULT_LATENCY_BUCKETS,
    DEFAULT_RATE_BUCKETS,
    REGISTRY,
    Registry,
    StateGauge,
)
from .trace import (  # noqa: F401
    FLIGHT_RECORDER,
    SpanRing,
    TraceContext,
    TraceWriter,
    emit_span,
)
from .stepline import (  # noqa: F401
    PHASES,
    StepProfiler,
    StepRecord,
    debug_snapshot,
)
from .http import MetricsServer  # noqa: F401
