"""Load-driven replica autoscaling with hysteresis for the dp daemon: the
port's own copy of ``llm_sharding_tpu/runtime/autoscale.py`` (stdlib only),
the policy unchanged.

``ReplicatedServer`` has the *mechanism* of elasticity — ``drain()``
migrates every live stream off a replica and frees its device group,
``spawn_replica()`` re-stages a fresh replica from the host-staged weights
— but sizing was an operator typing ``:drain N`` / ``:spawn``. This module
is the *policy*: a deterministic controller that reads the load the
serving stack already measures (backend queue depth + in-flight rows +
the ingress fair-queue backlog, normalized by live slot capacity) and
drives drain/spawn between ``min_replicas`` and ``max_replicas``, so the
daemon self-sizes under a diurnal load curve.

Hysteresis, because replica churn is expensive (a spawn re-stages weights
from the host copy; a drain migrates live streams): scale-up and
scale-down use SEPARATE thresholds, each must hold for its own sustain
window, and every action starts a cooldown during which the controller
only observes. Scale-up is deliberately twitchier than scale-down
(up_after_s < down_after_s by default) — under-capacity sheds user
traffic, over-capacity just wastes a replica's memory for a few seconds.

Stdlib-only; the clock is injectable so tests drive the
controller through a synthetic diurnal curve deterministically. The
controller is NOT a thread — the owner (the ingress pump loop, or the
CLI daemon loop) calls ``tick()`` at whatever cadence it steps.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from ..obs.metrics import (
    AUTOSCALE_DRAINS, AUTOSCALE_LOAD, AUTOSCALE_REPLICAS, AUTOSCALE_SPAWNS,
)
from ..obs.trace import emit_span
from ..analysis.lockorder import named_lock

logger = logging.getLogger("llm_sharding_tpu_torch.autoscale")


class Autoscaler:
    """Hysteresis controller over a ``ReplicatedServer``.

    ``target`` must expose ``servers`` (live replicas), ``spawn_replica()``
    and ``drain(group)`` — the supervised router's elasticity surface.
    ``extra_load`` (e.g. the ingress fair-queue ``depth``) adds work the
    backend cannot see yet; ``load_fn`` replaces the whole signal for
    tests. ``tick()`` returns ``"spawn"``, ``"drain"`` or ``None`` so
    callers (and tests) observe every decision."""

    def __init__(
        self,
        target,
        *,
        min_replicas: Optional[int] = None,
        max_replicas: Optional[int] = None,
        scale_up_load: float = 0.8,
        scale_down_load: float = 0.3,
        up_after_s: float = 1.0,
        down_after_s: float = 5.0,
        cooldown_s: float = 3.0,
        clock: Callable[[], float] = time.monotonic,
        extra_load: Optional[Callable[[], int]] = None,
        load_fn: Optional[Callable[[], float]] = None,
        rebalance_every_s: float = 0.0,
    ):
        if not 0 < scale_down_load < scale_up_load:
            raise ValueError(
                f"need 0 < scale_down_load < scale_up_load, got "
                f"{scale_down_load} / {scale_up_load}"
            )
        if min(up_after_s, down_after_s, cooldown_s) < 0:
            raise ValueError("sustain windows and cooldown must be >= 0")
        self.target = target
        groups = len(getattr(target, "_groups", target.servers))
        self.min_replicas = int(
            min_replicas if min_replicas is not None
            else max(getattr(target, "min_replicas", 1), 1)
        )
        self.max_replicas = int(
            max_replicas if max_replicas is not None else groups
        )
        if not 1 <= self.min_replicas <= self.max_replicas <= groups:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas <= device groups, "
                f"got {self.min_replicas} / {self.max_replicas} / {groups}"
            )
        self.scale_up_load = float(scale_up_load)
        self.scale_down_load = float(scale_down_load)
        self.up_after_s = float(up_after_s)
        self.down_after_s = float(down_after_s)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._extra_load = extra_load
        self._load_fn = load_fn
        self._high_since: Optional[float] = None
        self._low_since: Optional[float] = None
        self._cooldown_until = -float("inf")
        self._lock = named_lock("autoscale.controller")
        self.spawns = 0
        self.drains = 0
        # paced auto-rebalance: every rebalance_every_s
        # the tick also asks a disaggregated target to converge its
        # prefill:decode ratio toward the planner's choice for the observed
        # mix (DisaggServer.rebalance — one role flip per call, riding the
        # same drain/spawn path as the scale actions). 0 = off; silently
        # off when the target has no rebalance()/planner.
        self.rebalance_every_s = float(rebalance_every_s)
        self.rebalances = 0
        self._next_rebalance_at = (
            clock() + self.rebalance_every_s if self.rebalance_every_s > 0
            else float("inf")
        )

    # ------------------------------------------------------------ signal

    def load(self) -> float:
        """(queued + in-flight + ingress backlog) / live slot capacity.
        >= 1.0 means every live slot is busy AND work is waiting; the
        signal keeps growing with backlog (it is not clamped), so a flood
        reads as e.g. 3.0, not a saturated 1.0.

        A disaggregated router (``runtime/disagg.DisaggServer``) exposes
        ``role_load``, and the controller defers to it: the signal becomes
        the WORST role pool's normalized load, so a saturated prefill tier
        triggers scale-up even while the decode tier idles (the skew a
        global average hides)."""
        if self._load_fn is not None:
            return float(self._load_fn())
        role_load = getattr(self.target, "role_load", None)
        if role_load is not None:
            return float(role_load(
                extra=int(self._extra_load()) if self._extra_load else 0
            ))
        busy = slots = 0
        for s in list(self.target.servers):
            if getattr(s, "_closed", False):
                continue
            busy += len(s._queue)
            busy += sum(r is not None and not r.done for r in s._req)
            slots += len(s._req)
        if self._extra_load is not None:
            busy += int(self._extra_load())
        if slots == 0:
            # no live replica at all: anything queued is infinite overload
            return float("inf") if busy else 0.0
        return busy / slots

    # ------------------------------------------------------------ control

    def tick(self, now: Optional[float] = None) -> Optional[str]:
        """One control decision. Reads the load signal, advances the
        sustain windows, and — outside the cooldown — spawns at sustained
        high load below ``max_replicas`` or drains the least-loaded
        replica at sustained low load above ``min_replicas``."""
        with self._lock:
            now = self._clock() if now is None else float(now)
            load = self.load()
            live = len(self.target.servers)
            AUTOSCALE_LOAD.set(load)
            AUTOSCALE_REPLICAS.set(live)

            if load >= self.scale_up_load:
                self._low_since = None
                if self._high_since is None:
                    self._high_since = now
            elif load <= self.scale_down_load:
                self._high_since = None
                if self._low_since is None:
                    self._low_since = now
            else:
                self._high_since = self._low_since = None

            if (
                self.rebalance_every_s > 0
                and now >= self._next_rebalance_at
            ):
                self._next_rebalance_at = now + self.rebalance_every_s
                self._maybe_rebalance()

            if now < self._cooldown_until:
                return None

            if (
                self._high_since is not None
                and now - self._high_since >= self.up_after_s
                and live < self.max_replicas
            ):
                try:
                    self.target.spawn_replica()
                except (ValueError, RuntimeError) as e:
                    logger.warning("autoscale spawn refused: %s", e)
                    return None
                self.spawns += 1
                AUTOSCALE_SPAWNS.inc()
                self._cooldown_until = now + self.cooldown_s
                self._high_since = None
                emit_span(
                    None, "autoscale", src="autoscaler", action="spawn",
                    load=round(load, 3), live=len(self.target.servers),
                )
                logger.info(
                    "autoscale: spawned a replica at load %.2f (%d live)",
                    load, len(self.target.servers),
                )
                return "spawn"

            if (
                self._low_since is not None
                and now - self._low_since >= self.down_after_s
                and live > self.min_replicas
            ):
                d = self._least_loaded_group()
                if d is None:
                    return None
                try:
                    self.target.drain(d)
                except (ValueError, RuntimeError) as e:
                    logger.warning("autoscale drain refused: %s", e)
                    return None
                self.drains += 1
                AUTOSCALE_DRAINS.inc()
                self._cooldown_until = now + self.cooldown_s
                self._low_since = None
                emit_span(
                    None, "autoscale", src="autoscaler", action="drain",
                    replica=d, load=round(load, 3),
                    live=len(self.target.servers),
                )
                logger.info(
                    "autoscale: drained replica %d at load %.2f (%d live)",
                    d, load, len(self.target.servers),
                )
                return "drain"
            return None

    def _maybe_rebalance(self) -> None:
        """One paced role-rebalance attempt on a disaggregated target (a
        no-op for plain routers and planner-less disagg routers). The flip
        itself — and the drain/spawn it rides — emits its own decision
        spans; failures are logged and never take the tick loop down."""
        rebalance = getattr(self.target, "rebalance", None)
        if rebalance is None or getattr(self.target, "planner", None) is None:
            return
        try:
            flipped = rebalance()
        except (ValueError, RuntimeError) as e:
            logger.warning("autoscale rebalance refused: %s", e)
            return
        if flipped is not None:
            self.rebalances += 1

    def _least_loaded_group(self) -> Optional[int]:
        """The device-group index of the live replica with the least work
        — draining it migrates the fewest streams."""
        helper = getattr(self.target, "least_loaded_group", None)
        if helper is not None:
            return helper()
        return None
