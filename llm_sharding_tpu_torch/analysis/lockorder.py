"""The canonical lock hierarchy and the runtime lock-order tracker: the
port's own copy of the runtime half of ``llm_sharding_tpu/analysis/lockorder.py``
(``ORDER``, ``named_lock``, the tracked and the timed modes). That module is
stdlib only, but the port imports nothing of the JAX package. The static
half is the port's own lock-order rule (``rule_lockorder.py``), which reads
``ORDER``: ``python -m llm_sharding_tpu_torch lint``.

Every lock the port's runtime and obs modules hold is built by
:func:`named_lock` under a name of ``ORDER`` (the JAX package's names, so
one hierarchy covers both):

- **tracked mode**: with ``SHARDLINT_LOCK_ORDER=1`` in the environment (or
  :func:`enable`) when a lock is built, the lock becomes a wrapper that
  raises :class:`LockOrderViolation`, naming both acquisition stacks, the
  moment a thread acquires a lock that ranks above one it already holds;
- **timed mode**: with ``STEPLINE_LOCK_TIMING=1`` (or :func:`enable_timing`)
  every named lock also times how long ``acquire`` blocked, accumulating
  per-name totals (:func:`wait_totals`) and feeding an optional sink
  (:func:`set_wait_sink`: ``obs.stepline`` installs one that observes
  ``server_lock_wait_seconds{lock}``).

Both modes are chosen when a lock is built; by default ``named_lock``
returns the plain ``threading`` primitive, with no overhead.

Rules of the hierarchy:

- A thread may only acquire locks of **equal or later rank** than every
  lock it already holds (outer locks first). Equal rank is allowed because
  several same-named instances (one ``server.mutex`` per server) may be
  held under an outer lock that serializes them.
- Re-acquiring the **same instance** is always fine (``server.mutex`` is
  an RLock by design).
- A new lock is built through :func:`named_lock` with a name listed in
  ``ORDER``; an unknown name raises.
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional, Tuple

#: The canonical acquisition order, OUTERMOST first. Derived from the
#: static lock-acquisition graph over the runtime/obs modules (see
#: ``rule_lockorder``) and asserted live by the tracker.
#:
#: The shape of the hierarchy: front-door pumps (ingress) sit outside the
#: control plane (autoscaler, replica router), which sits outside the
#: per-replica serving mutex; per-subsystem leaves (engine reconfig, fault
#: plans, fair-queue state) nest inside a server step; observability locks
#: (trace ring/writer, metric families) are innermost — every subsystem
#: records telemetry while holding its own lock, and obs never calls back
#: out.
ORDER: Tuple[str, ...] = (
    "ingress.pump_gate",      # pause() gate around a full dispatch pump
    "ingress.state",          # IngressServer._mutex: live-set + counters
    "autoscale.controller",   # tick state; holds while spawn/drain/rebal
    "replica.router",         # ReplicatedServer._lock (RLock)
    "server.prefetcher",      # _Prefetcher singleton construction
    "server.mutex",           # PipelineServer._mutex (RLock): step state
    "server.scheduler",       # async-exec scheduler kick/delta condition
    "server.exec_sidecar",    # async-exec completion-sidecar wake condition
    "disagg.handoff",         # sidecar rendezvous condition (counters only)
    "cluster.index",          # global radix index map (publish/lookup)
    "engine.reconfig",        # PipelineEngine._lock: placement swap vs use
    "faults.plan",            # FaultPlan arming/matching
    "fairness.queue",         # FairQueue state (tenant heaps, service)
    "fairness.bucket",        # per-tenant TokenBucket (consulted by queue)
    "obs.trace.ring",         # flight-recorder ring
    "obs.trace.writer",       # JSONL span writer
    "obs.stepline.ring",      # step-profiler record ring
    "obs.metrics.registry",   # family name -> family map
    "obs.metrics.stategauge", # one-hot flip serialization (then family)
    "obs.metrics.family",     # every counter/gauge/histogram child
    "obs.metrics.shape_keys", # jit shape-key seen-set
)

_RANK = {name: i for i, name in enumerate(ORDER)}

ENV_FLAG = "SHARDLINT_LOCK_ORDER"

#: Tracking enabled? Read once at import (CI lanes export the flag before
#: pytest starts); tests flip it via :func:`enable` BEFORE constructing the
#: locks they want tracked — the choice is baked in at construction time.
_enabled = os.environ.get(ENV_FLAG, "").strip() not in ("", "0", "false")


def enabled() -> bool:
    return _enabled


def enable(on: bool = True) -> None:
    """Force tracking on/off for locks constructed AFTER this call."""
    global _enabled
    _enabled = bool(on)


TIMING_ENV_FLAG = "STEPLINE_LOCK_TIMING"

#: Lock-wait timing enabled? Same construction-time semantics as ``_enabled``
#: above: read once at import, flipped by :func:`enable_timing` for locks
#: constructed afterwards.
_timing_enabled = (
    os.environ.get(TIMING_ENV_FLAG, "").strip() not in ("", "0", "false")
)

#: name -> [acquire_count, total_blocked_seconds]; guarded by ``_waits_mu``.
#: A plain lock is fine here: analysis/ sits outside the runtime hierarchy
#: and this is a leaf no callback ever re-enters.
_WAITS: Dict[str, List[float]] = {}
_waits_mu = threading.Lock()

#: Optional per-wait callback ``fn(name, blocked_seconds)``, called OUTSIDE
#: ``_waits_mu`` after each timed acquire.
_SINK: Optional[Callable[[str, float], None]] = None


def timing_enabled() -> bool:
    return _timing_enabled


def enable_timing(on: bool = True) -> None:
    """Force lock-wait timing on/off for locks constructed AFTER this."""
    global _timing_enabled
    _timing_enabled = bool(on)


def set_wait_sink(fn: Optional[Callable[[str, float], None]]) -> None:
    """Install (or clear) the per-wait callback. One sink, process-wide."""
    global _SINK
    _SINK = fn


def wait_totals() -> Dict[str, Tuple[int, float]]:
    """Snapshot of ``{name: (acquire_count, total_blocked_seconds)}`` since
    process start (or :func:`reset_wait_totals`). Deep captures diff two
    snapshots to attribute lock waits to a step window."""
    with _waits_mu:
        return {k: (int(v[0]), float(v[1])) for k, v in _WAITS.items()}


def reset_wait_totals() -> None:
    with _waits_mu:
        _WAITS.clear()


def _record_wait(name: str, dt: float) -> None:
    with _waits_mu:
        ent = _WAITS.get(name)
        if ent is None:
            _WAITS[name] = ent = [0, 0.0]
        ent[0] += 1
        ent[1] += dt
    sink = _SINK
    if sink is not None:
        sink(name, dt)


class LockOrderViolation(AssertionError):
    """A thread acquired a lock ranking ABOVE one it already holds. The
    message carries both stacks: where the held (outer-ranked) lock was
    acquired and where the out-of-order acquisition happened."""


class _Tls(threading.local):
    def __init__(self):
        # [(tracked_lock, acquisition stack), ...] in acquisition order
        self.held: List[Tuple[object, str]] = []


_tls = _Tls()


def held_names() -> List[str]:
    """Lock names the calling thread currently holds (oldest first) —
    diagnostic helper for tests and postmortems."""
    return [t.name for t, _ in _tls.held]


def _check(incoming: "_TrackedBase") -> None:
    for held, held_stack in _tls.held:
        if held is incoming:
            return  # re-entrant acquisition of the same instance: fine
    for held, held_stack in _tls.held:
        if held.rank > incoming.rank:
            here = "".join(traceback.format_stack(limit=16)[:-2])
            raise LockOrderViolation(
                f"lock order violation: acquiring {incoming.name!r} "
                f"(rank {incoming.rank}) while holding {held.name!r} "
                f"(rank {held.rank}) — canonical order is outer-first "
                f"{ORDER!r}\n\n"
                f"--- stack that acquired {held.name!r} ---\n{held_stack}\n"
                f"--- stack acquiring {incoming.name!r} ---\n{here}"
            )


def _push(lock: "_TrackedBase") -> None:
    _tls.held.append(
        (lock, "".join(traceback.format_stack(limit=16)[:-3]))
    )


def _pop(lock: "_TrackedBase") -> None:
    for i in range(len(_tls.held) - 1, -1, -1):
        if _tls.held[i][0] is lock:
            del _tls.held[i]
            return


class _TrackedBase:
    __slots__ = ("name", "rank", "_inner")

    def __init__(self, name: str, inner):
        self.name = name
        self.rank = _RANK[name]
        self._inner = inner

    def acquire(self, *a, **kw) -> bool:
        _check(self)
        got = self._inner.acquire(*a, **kw)
        if got:
            _push(self)
        return got

    def release(self) -> None:
        self._inner.release()
        _pop(self)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<tracked {self.name} {self._inner!r}>"


class TrackedLock(_TrackedBase):
    pass


class TrackedRLock(_TrackedBase):
    pass


class TrackedCondition(_TrackedBase):
    """Condition wrapper: order-checked at acquisition; ``wait`` releases
    and re-acquires the SAME instance, which is order-neutral (the thread
    blocks — it cannot acquire anything else meanwhile), so the held
    record simply stays for the duration of the ``with`` block."""

    def wait(self, timeout: Optional[float] = None):
        return self._inner.wait(timeout)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        return self._inner.wait_for(predicate, timeout)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()


class _TimedBase:
    """Times how long ``acquire`` blocked; wraps the plain primitive (or the
    tracking wrapper when both modes are on) and forwards everything else."""

    __slots__ = ("name", "_inner")

    def __init__(self, name: str, inner):
        self.name = name
        self._inner = inner

    def acquire(self, *a, **kw) -> bool:
        t0 = time.perf_counter()
        got = self._inner.acquire(*a, **kw)
        _record_wait(self.name, time.perf_counter() - t0)
        return got

    def release(self) -> None:
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<timed {self.name} {self._inner!r}>"


class TimedLock(_TimedBase):
    pass


class TimedRLock(_TimedBase):
    pass


class TimedCondition(_TimedBase):
    """``wait`` re-acquires the same instance after being notified; that
    wake-up contention is part of the condition's own protocol, not step
    work blocked on the lock, so only entry ``acquire`` is timed."""

    def wait(self, timeout: Optional[float] = None):
        return self._inner.wait(timeout)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        return self._inner.wait_for(predicate, timeout)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()


_KINDS = {
    "lock": (threading.Lock, TrackedLock, TimedLock),
    "rlock": (threading.RLock, TrackedRLock, TimedRLock),
    "condition": (threading.Condition, TrackedCondition, TimedCondition),
}


def named_lock(name: str, kind: str = "lock"):
    """Construct a lock registered in the canonical hierarchy.

    Returns a plain ``threading`` primitive when both opt-in modes are off
    (the default — zero steady-state overhead); a tracking wrapper when
    ``SHARDLINT_LOCK_ORDER=1`` (or :func:`enable`) was set at construction
    time; a wait-timing wrapper when ``STEPLINE_LOCK_TIMING=1`` (or
    :func:`enable_timing`) was — composed outside the tracker when both are
    on. ``name`` must appear in ``ORDER``; ``kind`` is one of ``lock`` /
    ``rlock`` / ``condition``."""
    if name not in _RANK:
        raise ValueError(
            f"lock name {name!r} is not in the canonical ORDER — add it to "
            f"llm_sharding_tpu_torch/analysis/lockorder.ORDER at its correct rank"
        )
    try:
        plain, tracked, timed = _KINDS[kind]
    except KeyError:
        raise ValueError(
            f"unknown lock kind {kind!r}; one of {sorted(_KINDS)}"
        ) from None
    lock = plain() if not _enabled else tracked(name, plain())
    if _timing_enabled:
        lock = timed(name, lock)
    return lock
