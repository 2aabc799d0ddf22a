"""Async executor: the scheduler/executor split behind ``inflight_steps``.
The port of ``llm_sharding_tpu/runtime/async_exec.py`` (whole).

With ``inflight_steps=1`` (the default) ``PipelineServer.step()`` is the
serial loop: one thread does everything (deadline sweep, radix staging,
admission, dispatch, the log read, per-row apply, gauge sweep) under the
server mutex, keeping ``pipeline_depth`` logs in flight.

``inflight_steps=N>1`` splits the loop three ways:

- the **executor** is ``step()`` itself, reduced to the hot path: consume
  the scheduler's published delta, admit if a row is free, dispatch the
  next chunk, and apply logs inline only when the in-flight window is full
  (backpressure). It keeps up to N decode dispatches enqueued on the card,
  legal because ``serve_chunk`` is self-contained: chunk k+1 reads the row
  state chunk k left on the device, never the host's copy of k's log;
- the :class:`_StepScheduler` thread plans the NEXT boundary's work off
  the critical path: deadline-sweep candidates (published as an immutable
  :class:`SchedulerDelta` the executor re-validates before acting on it),
  the queue head's staged radix plan, and the paced load-gauge sweep;
- the :class:`_CompletionSidecar` thread applies landed token logs and so
  feeds ``stream()`` / ``result()`` consumers between executor steps. It
  waits on the oldest entry's CUDA event outside every lock.

Correctness invariants:

- **Token identity**: the device runs one deterministic chain of programs
  whatever the host's threading, so greedy output is token-identical to
  the serial loop at every depth. Applies stay ordered (the sidecar and
  every inline drain pop ``_pending`` oldest-first under the server mutex),
  and late tokens for finished rows are skipped by the ``req.done``
  guards.
- **Settled boundaries**: the sidecar never holds an entry outside the
  mutex (it pops and applies in one critical section), so a ``_drain(0)``
  under the mutex (snapshot, admission, ``extract``'s settle) leaves no
  unapplied log anywhere.
- **Lock order**: both helper threads take their own condition
  (``server.scheduler`` / ``server.exec_sidecar``, ranked right after
  ``server.mutex``) and the server mutex strictly one after the other,
  never nested; the executor, holding the mutex, may notify either
  condition (later rank).
- **Liveness without the threads**: the executor falls back to the inline
  deadline sweep when no delta is published and applies logs itself at
  the in-flight cap: a starved scheduler or sidecar costs throughput,
  never correctness. A thread that dies is never silent: its exception is
  kept and the executor's next step raises it.

Both threads hold only a weakref to the server: an unclosed server parks
its threads until it is collected instead of being kept alive by them;
``close()`` stops and joins them.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from typing import Optional, Tuple

from ..analysis.lockorder import named_lock
from ..obs.metrics import REGISTRY

logger = logging.getLogger(__name__)

INFLIGHT_STEPS = REGISTRY.gauge(
    "server_inflight_steps",
    "Configured async-executor depth: how many decode dispatches may stay "
    "enqueued on device before the executor applies logs inline (1 = the "
    "serial step loop; last-constructed server wins across dp replicas)",
)
SCHEDULER_LAG = REGISTRY.histogram(
    "server_scheduler_lag_seconds",
    "Async executor: age of the scheduler's published delta when the "
    "executor applies it at a step boundary (planned -> applied) — the "
    "staleness bound on off-thread deadline/eviction planning",
)

# seconds a parked helper thread sleeps before it checks whether its server
# was collected (and the sidecar's bound on one wait for the device)
_PARK_S = 0.5
_WAIT_S = 0.1


class SchedulerDelta:
    """One immutable planning result, published scheduler → executor.

    The executor RE-VALIDATES every candidate against live state before
    acting (the request may have finished, admitted or been cancelled since
    plan time); ``planned_at`` feeds ``server_scheduler_lag_seconds`` at
    apply time. Radix staging and gauge sweeps run in place under the
    mutex on the scheduler thread and do not ride the delta."""

    __slots__ = ("planned_at", "plan_s", "expire_queued", "expire_rows")

    def __init__(self, planned_at: float, plan_s: float,
                 expire_queued: Tuple, expire_rows: Tuple):
        self.planned_at = planned_at
        self.plan_s = plan_s
        self.expire_queued = expire_queued  # Request, still queued at plan
        self.expire_rows = expire_rows  # (row, Request), in flight


class _HelperThread(threading.Thread):
    """A helper thread whose failure is never silent: an exception that
    escapes its loop is logged and kept in ``error``, and the executor's
    next step raises it (``PipelineServer._check_helpers``)."""

    def __init__(self, name: str):
        super().__init__(daemon=True, name=name)
        self.error: Optional[BaseException] = None

    def run(self) -> None:
        try:
            self._loop()
        except BaseException as e:  # noqa: BLE001 — surfaced by the executor
            logger.exception("%s thread failed", self.name)
            self.error = e

    def _loop(self) -> None:
        raise NotImplementedError


class _StepScheduler(_HelperThread):
    """Plans step k+2 while step k+1 executes: deadline-sweep candidates
    (→ :class:`SchedulerDelta`), the queue head's staged radix plan and the
    paced gauge sweep. Kicked once per executor step; parks on its
    condition otherwise. Plan time lands in the ``plan`` phase histogram
    through ``observe_offthread``: it overlaps the executor's wall, so it
    never enters a StepRecord."""

    def __init__(self, srv):
        super().__init__("serve-scheduler")
        self._ref = weakref.ref(srv)
        self._cv = named_lock("server.scheduler", "condition")
        self._kicked = False
        self._stopped = False
        self._delta: Optional[SchedulerDelta] = None

    def kick(self) -> None:
        """Request one planning pass (executor, end of step, under the
        server mutex: the condition ranks after it)."""
        with self._cv:
            self._kicked = True
            self._cv.notify()

    def take(self) -> Optional[SchedulerDelta]:
        """Consume the latest published delta (executor, start of step)."""
        with self._cv:
            d, self._delta = self._delta, None
            return d

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify()

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._kicked and not self._stopped:
                    if not self._cv.wait(_PARK_S) and self._ref() is None:
                        return  # server collected without close()
                if self._stopped:
                    return
                self._kicked = False
            srv = self._ref()
            if srv is None:
                return
            try:
                delta = self._plan(srv)
            except Exception:  # noqa: BLE001 — a planning failure must
                # never kill the thread: the executor's inline sweep keeps
                # correctness, only this step's overlap is lost
                logger.exception("scheduler plan failed; the executor falls back to "
                                 "the inline sweep")
                continue
            if delta is None:
                return  # server closed
            with self._cv:
                self._delta = delta
            srv.stepline.observe_offthread("plan", delta.plan_s)
            srv = None  # no strong reference while parked

    def _plan(self, srv) -> Optional[SchedulerDelta]:
        # one after the condition above, never nested in it: the mutex
        # ranks BEFORE server.scheduler in the canonical order
        t0 = time.perf_counter()
        with srv._mutex:
            if srv._closed:
                return None
            now = time.perf_counter()
            expire_queued = tuple(
                r for r in srv._queue if r.deadline_at is not None and now >= r.deadline_at
            )
            expire_rows = tuple(
                (i, r) for i, r in enumerate(srv._req)
                if r is not None and not r.done and r.deadline_at is not None
                and now >= r.deadline_at and i not in srv._admitting
            )
            if srv._radix is not None and srv._queue:
                # the serial loop's one-step-ahead staging: a host-tier
                # restore rides the device queue behind the chunks in flight
                srv._stage_radix_plan()
            if (srv.gauge_sweep_every_s <= 0.0
                    or now - srv._last_gauge_sweep >= srv.gauge_sweep_every_s):
                srv._sweep_gauges()
                srv._last_gauge_sweep = now
        return SchedulerDelta(
            planned_at=now, plan_s=time.perf_counter() - t0,
            expire_queued=expire_queued, expire_rows=expire_rows,
        )


class _CompletionSidecar(_HelperThread):
    """Applies landed token logs between executor steps, so committed
    tokens reach ``stream()`` / ``result()`` consumers without riding the
    step's critical path. Pops and applies strictly under the server mutex
    (never holding an entry across a lock release: the settled-boundary
    invariant), waits on the oldest in-flight entry's CUDA event OUTSIDE
    every lock, and re-checks after waking: the executor's own
    backpressure drain may have applied the entry first."""

    def __init__(self, srv):
        super().__init__("serve-exec-sidecar")
        self._ref = weakref.ref(srv)
        self._cv = named_lock("server.exec_sidecar", "condition")
        self._woken = False
        self._stopped = False
        self.applied = 0  # entries this thread applied

    def notify(self) -> None:
        """Wake the sidecar (executor, after dispatch, under the server
        mutex: the condition ranks after it)."""
        with self._cv:
            self._woken = True
            self._cv.notify()

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify()

    def _loop(self) -> None:
        while True:
            srv = self._ref()
            if srv is None:
                return
            with srv._mutex:
                if srv._closed:
                    return
                self.applied += srv._drain_landed()
                head = srv._pending[0] if srv._pending else None
            srv = None  # no strong reference while waiting or parked
            if head is not None:
                # the oldest in-flight log: wait for it WITHOUT taking it
                # (bounded: an inline drain may apply it first, and stop()
                # must not wait behind the device)
                try:
                    head.wait_landed(_WAIT_S)
                except Exception:  # noqa: BLE001 — a lost log: the drain
                    pass  # under the mutex pops and contains it
                head = None
                with self._cv:
                    if self._stopped:
                        return
                continue
            with self._cv:
                if self._stopped:
                    return
                if not self._woken:
                    self._cv.wait(_PARK_S)
                self._woken = False
