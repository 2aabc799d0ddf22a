"""Continuous step profiler: the serving loop's host–device ledger. The
port's own copy of ``llm_sharding_tpu/obs/stepline.py`` (whole: the phases,
``StepRecord``, ``StepProfiler``, the five metric families under the JAX
names, the lock-wait sink and ``debug_snapshot``).

- The step pump records one :class:`StepRecord` per serve-loop step into a
  bounded ring: per-phase host durations (``admit`` / ``radix_plan`` /
  ``table_push`` / ``dispatch`` / ``fetch`` / ``apply`` / ``gauge_sweep``,
  plus the async executor's ``publish`` / ``drain`` and the overlapped
  ``plan``), time *blocked on device* (on the card, the wait on the CUDA
  event recorded after a program's last launch, measured apart from host
  compute), the estimated device-idle bubble, rows in flight, tokens
  applied, and queue depths.
- Derived gauges feed continuously: ``server_host_occupancy``,
  ``server_device_idle_frac``, ``server_step_wall_seconds``.
- Lock-wait accounting rides the :func:`~..analysis.lockorder.named_lock`
  factory's opt-in timed mode (``STEPLINE_LOCK_TIMING=1``); this module
  installs the process-wide sink that observes
  ``server_lock_wait_seconds{lock}``.
- An on-demand deep capture (``/profilez?steps=N``) arms an N-step window
  that additionally keeps the full sub-phase segment timeline, per-step
  lock-wait deltas, and trace_id exemplars of applied rows, returned as
  one JSON-ready bundle.

Accounting invariant: phases are measured as DISJOINT stack segments (a
nested phase's elapsed time is excluded from its parent) and blocked time
is excluded from the phase it interrupts, so ``sum(phases) + blocked_s +
unattributed_s == wall_s`` exactly, with ``unattributed_s`` (inter-phase
gaps: autosnapshot, metric observes) expected under 5% of wall.

The recording API (``begin_step``/``push``/``pop``/``blocked``/``idle``/
``end_step``) is single-threaded by construction (only the step pump calls
it), so recording state is unlocked; only the ring itself takes a lock
(``obs.stepline.ring``), and gauge/histogram feeds happen outside it. Work
on another thread that overlaps the pump's wall clock is reported through
:meth:`StepProfiler.observe_offthread`, which feeds the phase histogram
only and stays out of :class:`StepRecord`: folding overlapped time into a
step's phases would break the accounting invariant.

Everything here is stdlib-only: ``step-report`` runs without torch.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Callable, Dict, List, Optional

from ..analysis import lockorder
from .metrics import REGISTRY

#: Canonical phase names, in typical per-step order. ``push`` accepts only
#: these so the metric's label space stays closed.
PHASES = (
    "admit",       # shed + ingress drain + prefill admission (incl. flush)
    "radix_plan",  # radix-tree chunk planning / staged plan refresh
    "table_push",  # block-table host->device push
    "dispatch",    # host-side chunk/spec dispatch (device executes async)
    "fetch",       # drain bookkeeping around the log fetch (host part)
    "apply",       # applying fetched token logs to requests
    "gauge_sweep", # load/KV/attn gauge sweep (pace via gauge_sweep_every_s)
    # async-executor phases (inflight_steps > 1):
    "plan",        # scheduler's off-thread planning (histogram-only: it
                   # OVERLAPS executor wall, so it never enters StepRecord
                   # phases — see observe_offthread)
    "publish",     # executor consuming the scheduler's published delta
    "drain",       # executor-inline settle/backpressure drain of in-flight
                   # dispatches (the fetch/apply sub-phases nest inside)
)

_PHASE_SET = frozenset(PHASES)

STEP_PHASE = REGISTRY.histogram(
    "server_step_phase_seconds",
    "Serving-loop host phase durations, disjoint per step: admit (shed + "
    "ingress drain + prefill admission), radix_plan (chunk planning), "
    "table_push (block-table push), dispatch (host-side chunk/spec "
    "dispatch), fetch (drain bookkeeping around the log fetch), apply "
    "(token-log application), gauge_sweep (load/KV/attn gauge sweep), and "
    "with the async executor (inflight_steps > 1): plan (scheduler's "
    "overlapped off-thread planning; histogram-only), publish (delta "
    "consumption), drain (executor-inline settle of in-flight dispatches)",
    labels=("phase",),
)
STEP_WALL = REGISTRY.histogram(
    "server_step_wall_seconds",
    "Wall time of one serve-loop step (all phases + device-blocked wait)",
)
HOST_OCCUPANCY = REGISTRY.gauge(
    "server_host_occupancy",
    "Fraction of step wall spent on host-side work (vs blocked on device), "
    "from the most recent step of any live server (last-writer-wins across "
    "dp replicas; per-replica values ride ReplicatedServer.stats())",
)
DEVICE_IDLE_FRAC = REGISTRY.gauge(
    "server_device_idle_frac",
    "Estimated device-idle bubble per step: time between the newest "
    "in-flight chunk's log landing on host and the next dispatch, as a "
    "fraction of step wall (most recent step of any live server)",
)
LOCK_WAIT = REGISTRY.histogram(
    "server_lock_wait_seconds",
    "Time acquire() blocked on a named runtime lock — populated only in "
    "the opt-in STEPLINE_LOCK_TIMING=1 mode (zero-overhead plain "
    "primitives otherwise)",
    labels=("lock",),
)


# Per-phase histogram children resolved ONCE: the per-step feed is the
# profiler's hot path, and the label space is closed over PHASES — no
# reason to pay the family lock + label lookup on every step.
_PHASE_CHILD = {p: STEP_PHASE.labels(phase=p) for p in PHASES}


def _lock_wait_sink(name: str, dt: float) -> None:
    # The obs-internal locks are themselves timed in STEPLINE_LOCK_TIMING
    # mode, and observing LOCK_WAIT acquires one — recording THEIR waits
    # here would recurse into the very lock being recorded. They stay
    # visible through lockorder.wait_totals() (the deep capture's per-step
    # deltas); only the histogram skips them.
    if name.startswith("obs."):
        return
    LOCK_WAIT.labels(lock=name).observe(dt)


# The sink is a process-wide no-op until timed locks exist (the timed mode
# is construction-time opt-in), so installing it unconditionally is free.
lockorder.set_wait_sink(_lock_wait_sink)

#: Exemplar trace_ids kept per armed step (bounded; first writers win).
_EXEMPLARS_PER_STEP = 8

#: Live profilers, for the process-wide /debugz step-ring tail.
_LIVE: "weakref.WeakSet[StepProfiler]" = weakref.WeakSet()


class StepRecord:
    """One serve-loop step's accounting. Plain data; ``to_dict`` is the
    wire/JSON form used by the ring snapshot, /profilez, and /debugz."""

    __slots__ = (
        "ts", "wall_s", "phases", "blocked_s", "idle_s", "unattributed_s",
        "rows", "tokens", "queued", "pending", "segments", "lock_waits",
        "exemplars",
    )

    def __init__(self, ts, wall_s, phases, blocked_s, idle_s,
                 unattributed_s, rows, tokens, queued, pending,
                 segments=None, lock_waits=None, exemplars=None):
        self.ts = ts
        self.wall_s = wall_s
        self.phases = phases
        self.blocked_s = blocked_s
        self.idle_s = idle_s
        self.unattributed_s = unattributed_s
        self.rows = rows
        self.tokens = tokens
        self.queued = queued
        self.pending = pending
        self.segments = segments
        self.lock_waits = lock_waits
        self.exemplars = exemplars

    @property
    def host_s(self) -> float:
        return sum(self.phases.values())

    @property
    def occupancy(self) -> float:
        return self.host_s / self.wall_s if self.wall_s > 0 else 0.0

    def to_dict(self) -> dict:
        d = {
            "ts": self.ts,
            "wall_s": self.wall_s,
            "phases": dict(self.phases),
            "blocked_s": self.blocked_s,
            "idle_s": self.idle_s,
            "unattributed_s": self.unattributed_s,
            "host_s": self.host_s,
            "occupancy": self.occupancy,
            "rows": self.rows,
            "tokens": self.tokens,
            "queued": self.queued,
            "pending": self.pending,
        }
        if self.segments is not None:
            d["segments"] = [list(s) for s in self.segments]
        if self.lock_waits is not None:
            d["lock_waits"] = dict(self.lock_waits)
        if self.exemplars is not None:
            d["exemplars"] = list(self.exemplars)
        return d


class StepProfiler:
    """Bounded-ring step profiler with an armable deep-capture window.

    ``clock`` is injectable for tests (defaults to ``time.perf_counter``).
    ``set_enabled(False)`` turns every recording call into a boolean check —
    the overhead bench's "off" arm."""

    def __init__(self, ring_size: int = 512,
                 clock: Callable[[], float] = time.perf_counter,
                 name: str = "server"):
        if ring_size < 1:
            raise ValueError(f"ring_size must be >= 1, got {ring_size}")
        self.name = name
        self._clock = clock
        self._ring_size = int(ring_size)
        self._ring: List[StepRecord] = []
        self._ring_next = 0  # overwrite cursor once the ring is full
        self._ring_mu = lockorder.named_lock("obs.stepline.ring")
        self._enabled = True
        self.steps_total = 0
        # recording state (step-pump thread only; unlocked by design)
        self._t0: Optional[float] = None
        self._step_armed = False
        self._stack: List[list] = []  # [name, start, excluded_s]
        self._phases: Dict[str, float] = {}
        self._blocked_s = 0.0
        self._idle_s = 0.0
        self._segments: Optional[List[tuple]] = None
        self._exemplars: Optional[List[str]] = None
        self._lock_base: Optional[Dict[str, tuple]] = None
        # deep-capture state (armed by any thread; consumed by the pump)
        self._armed_left = 0
        self._capture: List[StepRecord] = []
        self._capture_requested = 0
        self._capture_done = threading.Event()
        self._capture_done.set()
        _LIVE.add(self)

    # -- enable / arm -------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, on: bool) -> None:
        self._enabled = bool(on)

    def arm(self, steps: int) -> None:
        """Arm an N-step deep capture. The next N completed steps keep the
        full sub-phase segment timeline, lock-wait deltas, and applied-row
        trace_id exemplars; :meth:`wait_capture` unblocks when done."""
        steps = int(steps)
        if steps < 1:
            raise ValueError(f"capture steps must be >= 1, got {steps}")
        self._capture = []
        self._capture_requested = steps
        self._capture_done.clear()
        self._armed_left = steps  # publish last: the pump checks this

    @property
    def armed(self) -> bool:
        return self._armed_left > 0

    def wait_capture(self, timeout: Optional[float] = None) -> bool:
        return self._capture_done.wait(timeout)

    def capture_bundle(self) -> dict:
        """The current (possibly still filling) deep capture as one
        JSON-ready bundle."""
        steps = [r.to_dict() for r in self._capture]
        return {
            "profiler": self.name,
            "steps_requested": self._capture_requested,
            "steps_captured": len(steps),
            "complete": self._capture_done.is_set()
            and bool(self._capture_requested),
            "lock_timing": lockorder.timing_enabled(),
            "steps": steps,
        }

    def capture(self, steps: int, wait_s: float = 5.0) -> dict:
        """Arm, wait up to ``wait_s`` for N steps to land, return the
        bundle (``complete: false`` if the loop went idle first)."""
        self.arm(steps)
        self.wait_capture(wait_s)
        return self.capture_bundle()

    # -- recording API (step-pump thread only) --------------------------------

    def begin_step(self) -> None:
        if not self._enabled:
            return
        self._t0 = self._clock()
        self._stack = []
        self._phases = {}
        self._blocked_s = 0.0
        self._idle_s = 0.0
        # a step only joins the capture window if it was armed at BEGIN —
        # arming mid-step (the /profilez handler races the pump) must not
        # count the half-observed step, which has no segment timeline
        self._step_armed = self._armed_left > 0
        if self._step_armed:
            self._segments = []
            self._exemplars = []
            self._lock_base = (
                lockorder.wait_totals()
                if lockorder.timing_enabled() else None
            )
        else:
            self._segments = None
            self._exemplars = None
            self._lock_base = None

    def push(self, phase: str) -> None:
        if not self._enabled or self._t0 is None:
            return
        if phase not in _PHASE_SET:
            raise ValueError(f"unknown phase {phase!r}; one of {PHASES}")
        self._stack.append([phase, self._clock(), 0.0])

    def pop(self) -> None:
        if not self._enabled or self._t0 is None or not self._stack:
            return
        name, start, excluded = self._stack.pop()
        now = self._clock()
        elapsed = now - start
        self._phases[name] = self._phases.get(name, 0.0) + max(
            0.0, elapsed - excluded
        )
        if self._stack:  # nested: parent must not double-count this span
            self._stack[-1][2] += elapsed
        if self._segments is not None:
            self._segments.append(
                (name, start - self._t0, max(0.0, elapsed - excluded))
            )

    def blocked(self, dt: float) -> None:
        """Account ``dt`` seconds of the step as blocked-on-device; it is
        excluded from the phase it interrupted."""
        if not self._enabled or self._t0 is None or dt <= 0.0:
            return
        self._blocked_s += dt
        if self._stack:
            self._stack[-1][2] += dt

    def idle(self, dt: float) -> None:
        """Account an estimated device-idle bubble (log landed on host at
        T, next dispatch at T+dt). Host time, not excluded from phases."""
        if not self._enabled or self._t0 is None or dt <= 0.0:
            return
        self._idle_s += dt

    def observe_offthread(self, phase: str, dt: float) -> None:
        """Feed ``dt`` seconds into the phase histogram from a thread that
        is NOT the step pump (scheduler plan, sidecar work). Histogram
        observes are thread-safe; recording state is never touched, and the
        sample stays out of StepRecord — off-thread work overlaps the
        pump's wall, so folding it into a step's phases would break the
        ``sum(phases) + blocked + unattributed == wall`` invariant."""
        if not self._enabled or dt < 0.0:
            return
        if phase not in _PHASE_SET:
            raise ValueError(f"unknown phase {phase!r}; one of {PHASES}")
        _PHASE_CHILD[phase].observe(dt)

    def note_exemplar(self, trace_id: str) -> None:
        """Record an applied row's trace_id — deep-capture steps only."""
        ex = self._exemplars
        if ex is not None and len(ex) < _EXEMPLARS_PER_STEP:
            ex.append(trace_id)

    def end_step(self, rows: int = 0, tokens: int = 0, queued: int = 0,
                 pending: int = 0) -> Optional[StepRecord]:
        if not self._enabled or self._t0 is None:
            return None
        while self._stack:  # unbalanced push (exception paths): close out
            self.pop()
        wall = max(self._clock() - self._t0, 0.0)
        self._t0 = None
        phases = self._phases
        host = sum(phases.values())
        unattributed = max(0.0, wall - host - self._blocked_s)
        lock_waits = None
        if self._lock_base is not None:
            lock_waits = {}
            for k, (n, s) in lockorder.wait_totals().items():
                bn, bs = self._lock_base.get(k, (0, 0.0))
                if n > bn:
                    lock_waits[k] = {"count": n - bn, "wait_s": s - bs}
        rec = StepRecord(
            ts=time.time(), wall_s=wall, phases=phases,
            blocked_s=self._blocked_s, idle_s=self._idle_s,
            unattributed_s=unattributed, rows=int(rows), tokens=int(tokens),
            queued=int(queued), pending=int(pending),
            segments=self._segments, lock_waits=lock_waits,
            exemplars=self._exemplars,
        )
        with self._ring_mu:
            if len(self._ring) < self._ring_size:
                self._ring.append(rec)
            else:
                self._ring[self._ring_next] = rec
                self._ring_next = (self._ring_next + 1) % self._ring_size
            self.steps_total += 1
        # metric feeds OUTSIDE the ring lock (family locks rank below it,
        # but obs never needs to nest — keep the ring hold minimal)
        for name, dur in phases.items():
            _PHASE_CHILD[name].observe(dur)
        STEP_WALL.observe(wall)
        if wall > 0:
            HOST_OCCUPANCY.set(min(1.0, host / wall))
            DEVICE_IDLE_FRAC.set(min(1.0, self._idle_s / wall))
        if self._step_armed and self._armed_left > 0:
            self._capture.append(rec)
            self._armed_left -= 1
            if self._armed_left == 0:
                self._capture_done.set()
        return rec

    # -- readers (any thread) -----------------------------------------------

    def snapshot(self, last_n: Optional[int] = None) -> List[dict]:
        """The ring's records oldest-first (the tail ``last_n`` if given)."""
        with self._ring_mu:
            ordered = (
                self._ring[self._ring_next:] + self._ring[:self._ring_next]
            )
        if last_n is not None:
            ordered = ordered[-int(last_n):]
        return [r.to_dict() for r in ordered]

    def stats(self, last_n: int = 64) -> dict:
        """Aggregates over the tail of the ring: duration-weighted host
        occupancy and device-idle fraction, p50 step wall."""
        with self._ring_mu:
            ordered = (
                self._ring[self._ring_next:] + self._ring[:self._ring_next]
            )
            total = self.steps_total
        tail = ordered[-int(last_n):]
        if not tail:
            return {
                "steps": total, "host_occupancy": 0.0,
                "device_idle_frac": 0.0, "step_wall_p50_ms": 0.0,
            }
        walls = sorted(r.wall_s for r in tail)
        wall_sum = sum(walls)
        host_sum = sum(r.host_s for r in tail)
        idle_sum = sum(r.idle_s for r in tail)
        p50 = walls[(len(walls) - 1) // 2]
        return {
            "steps": total,
            "host_occupancy": (
                min(1.0, host_sum / wall_sum) if wall_sum > 0 else 0.0
            ),
            "device_idle_frac": (
                min(1.0, idle_sum / wall_sum) if wall_sum > 0 else 0.0
            ),
            "step_wall_p50_ms": p50 * 1e3,
        }


def debug_snapshot(limit: int = 32) -> List[dict]:
    """Step-ring tails of every live profiler, for the /debugz flight
    recorder: what the loop was DOING, not just what spans it emitted."""
    out = []
    for p in sorted(_LIVE, key=lambda p: p.name):
        out.append({
            "profiler": p.name,
            "stats": p.stats(),
            "steps": p.snapshot(limit),
        })
    return out
