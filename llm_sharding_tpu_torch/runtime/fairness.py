"""Multi-tenant fairness primitives for the ingress (the port of
``llm_sharding_tpu/runtime/fairness.py``, whole): per-tenant token-bucket
rate limits and weighted fair queueing by accumulated service.

The backend server enforces global overload policy (a bounded queue with a
typed ``QueueFull``, per-request deadlines); its queue is FIFO, so it
cannot keep one flooding tenant from taking every slot ahead of the
others. This module holds the admission-side state the backend never
sees:

- ``TokenBucket``: the per-tenant rate limit. A refused request learns
  ``retry_after()``, so the ingress sheds it early with a 429 and a
  ``Retry-After`` instead of letting it die of a queue timeout.
- ``FairQueue``: weighted fair queueing after Virtual Token Counter
  scheduling (OSDI'24, "Fairness in Serving Large Language Models"). Each
  tenant carries an accumulated-service counter in tokens (prefill and
  decode) divided by its weight, and dispatch picks the backlogged tenant
  with the least. A tenant that floods only grows its own counter, so it
  only delays itself. A newly backlogged tenant is lifted to the
  scheduler's virtual time, so idle periods cannot be banked into a later
  burst.

Stdlib only, thread-safe under the port's ``named_lock``s
(``fairness.queue``, ``fairness.bucket``); ``clock`` is injectable, so the
tests drive both packages under one fake clock.
"""

from __future__ import annotations

import dataclasses
import json
import time
from collections import deque
from typing import Callable, Dict, Iterable, Optional, Tuple

from ..analysis.lockorder import named_lock
from ..obs.metrics import TENANT_QUEUED, TENANT_SERVICE, TENANT_THROTTLED


class RateLimited(RuntimeError):
    """The tenant's token bucket is empty: shed NOW with a 429 and tell the
    client when to come back (``retry_after_s``)."""

    def __init__(self, tenant: str, retry_after_s: float):
        self.tenant = tenant
        self.retry_after_s = max(float(retry_after_s), 0.0)
        super().__init__(
            f"tenant {tenant!r} exceeded its rate limit; retry in "
            f"{self.retry_after_s:.3f}s"
        )


class TenantQueueFull(RuntimeError):
    """The tenant's queued-work cap is reached: its own backlog is the
    problem, so the shed is per-tenant (429), not global (503)."""

    def __init__(self, tenant: str, queued: int, cap: int):
        self.tenant = tenant
        self.retry_after_s = 1.0  # a queue drains in seconds, not millis
        super().__init__(
            f"tenant {tenant!r} has {queued} request(s) queued >= its cap "
            f"of {cap}; drain or retry later"
        )


class UnknownTenant(RuntimeError):
    """No tenant matched the request's credentials and the config has no
    default tenant — the ingress answers 401."""


class GlobalQueueFull(RuntimeError):
    """The ingress-wide queued-work cap is reached: the whole daemon is
    backlogged, so the shed is global (503 + Retry-After), not
    per-tenant."""

    def __init__(self, queued: int, cap: int):
        self.retry_after_s = 1.0
        super().__init__(
            f"ingress queue is full ({queued} >= {cap}); retry later"
        )


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill up to ``burst``.
    ``try_acquire`` never blocks — the ingress sheds instead of queueing
    throttled work — and ``retry_after`` reports when the next acquire of
    the same size would succeed. Thread-safe; ``clock`` is injectable for
    deterministic tests."""

    def __init__(
        self,
        rate: float,
        burst: float,
        clock: Callable[[], float] = time.monotonic,
    ):
        if rate <= 0:
            raise ValueError(f"rate must be > 0 tokens/s, got {rate}")
        if burst <= 0:
            raise ValueError(f"burst must be > 0 tokens, got {burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._at = clock()
        self._lock = named_lock("fairness.bucket")

    def _refill(self, now: float) -> None:
        if now > self._at:
            self._tokens = min(
                self.burst, self._tokens + (now - self._at) * self.rate
            )
        self._at = now

    def try_acquire(self, n: float = 1.0) -> bool:
        with self._lock:
            self._refill(self._clock())
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def retry_after(self, n: float = 1.0) -> float:
        """Seconds until ``try_acquire(n)`` could succeed (0 = now)."""
        with self._lock:
            self._refill(self._clock())
            if self._tokens >= n:
                return 0.0
            return (n - self._tokens) / self.rate


@dataclasses.dataclass(frozen=True)
class TenantConfig:
    """One tenant's admission policy.

    ``key`` is the bearer credential (``Authorization: Bearer <key>``)
    that maps a request to this tenant; without keys the ``X-Tenant``
    header names the tenant directly. ``weight`` scales the tenant's fair
    share of service tokens; ``rate_rps``/``burst`` arm the token bucket
    (None = unlimited); ``max_queued`` caps the tenant's requests waiting
    in the ingress fair queue (None = unlimited)."""

    name: str
    key: Optional[str] = None
    weight: float = 1.0
    rate_rps: Optional[float] = None
    burst: Optional[float] = None
    max_queued: Optional[int] = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        if self.weight <= 0:
            raise ValueError(
                f"tenant {self.name!r}: weight must be > 0, got {self.weight}"
            )
        if self.rate_rps is not None and self.rate_rps <= 0:
            raise ValueError(
                f"tenant {self.name!r}: rate_rps must be > 0, got "
                f"{self.rate_rps}"
            )
        if self.burst is not None and self.rate_rps is None:
            raise ValueError(
                f"tenant {self.name!r}: burst without rate_rps is meaningless"
            )
        if self.max_queued is not None and self.max_queued < 1:
            raise ValueError(
                f"tenant {self.name!r}: max_queued must be >= 1, got "
                f"{self.max_queued}"
            )


def load_tenants_config(source) -> Tuple[Tuple[TenantConfig, ...], bool]:
    """Parse the ``--tenants-config`` JSON into tenant configs.

    Accepts a path, a JSON string, or an already-parsed dict shaped::

        {"tenants": {"alice": {"key": "sk-a", "weight": 2.0,
                               "rate_rps": 10, "burst": 20,
                               "max_queued": 64},
                     "bob":   {"rate_rps": 5}},
         "allow_anonymous": true}

    Returns ``(configs, allow_anonymous)``. ``allow_anonymous`` (default
    True when no tenant carries a key, else False) controls whether a
    request with no credentials lands on the built-in ``default`` tenant."""
    if isinstance(source, str):
        try:
            obj = json.loads(source)
        except json.JSONDecodeError:
            with open(source) as f:
                obj = json.load(f)
    else:
        obj = source
    if not isinstance(obj, dict):
        raise ValueError(
            f"tenants config must be a JSON object, got "
            f"{type(obj).__name__}"
        )
    tenants = []
    for name, spec in dict(obj.get("tenants", {})).items():
        tenants.append(TenantConfig(name=name, **dict(spec)))
    # the same invariants FairQueue construction enforces, surfaced HERE so
    # the CLI's pre-model-load fast-fail catches them in milliseconds
    # instead of the daemon dying minutes later at ingress construction
    keys = [t.key for t in tenants if t.key is not None]
    if len(keys) != len(set(keys)):
        raise ValueError("two tenants share the same bearer key")
    names = [t.name for t in tenants]
    if len(names) != len(set(names)):
        raise ValueError("duplicate tenant name")
    keyed = any(t.key is not None for t in tenants)
    allow_anon = bool(obj.get("allow_anonymous", not keyed))
    return tuple(tenants), allow_anon


#: The implicit tenant requests land on when no tenants are configured (or
#: anonymous access is allowed): unlimited rate, weight 1.
DEFAULT_TENANT = TenantConfig(name="default")


class _TenantState:
    __slots__ = ("cfg", "bucket", "service", "queue")

    def __init__(self, cfg: TenantConfig, clock):
        self.cfg = cfg
        self.bucket = (
            None if cfg.rate_rps is None else TokenBucket(
                cfg.rate_rps,
                cfg.burst if cfg.burst is not None else max(cfg.rate_rps, 1.0),
                clock,
            )
        )
        self.service = 0.0  # accumulated tokens / weight
        self.queue: deque = deque()


class FairQueue:
    """Weighted fair queue over tenants, scheduling by accumulated service.

    ``admit(name)`` runs the tenant's early-shed checks (token bucket,
    queued-work cap) and raises typed errors carrying ``retry_after_s``;
    ``push`` enqueues (FIFO within a tenant); ``pop`` returns the head of
    the least-served backlogged tenant; ``charge`` adds observed service
    (prefill/decode tokens ÷ weight) — the counters the next ``pop``
    compares. The global queue cap belongs to the ingress, not here: the
    fair queue only knows per-tenant policy."""

    def __init__(
        self,
        tenants: Iterable[TenantConfig] = (),
        *,
        allow_anonymous: bool = True,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._clock = clock
        self._lock = named_lock("fairness.queue")
        self._t: Dict[str, _TenantState] = {}
        self.allow_anonymous = bool(allow_anonymous)
        self._by_key: Dict[str, str] = {}
        for cfg in tenants:
            self._add(cfg)
        if "default" not in self._t and self.allow_anonymous:
            self._add(DEFAULT_TENANT)
        # scheduler virtual time: the normalized service of the last
        # dispatched tenant — the floor newly-backlogged tenants start at
        self._vt = 0.0

    def _add(self, cfg: TenantConfig) -> None:
        if cfg.name in self._t:
            raise ValueError(f"duplicate tenant {cfg.name!r}")
        if cfg.key is not None:
            if cfg.key in self._by_key:
                raise ValueError(
                    f"tenant {cfg.name!r} reuses another tenant's key"
                )
            self._by_key[cfg.key] = cfg.name
        self._t[cfg.name] = _TenantState(cfg, self._clock)

    # ------------------------------------------------------------ resolve

    def tenants(self) -> Tuple[str, ...]:
        return tuple(self._t)

    def config(self, name: str) -> TenantConfig:
        return self._t[name].cfg

    def resolve(
        self, *, bearer: Optional[str] = None, header: Optional[str] = None
    ) -> str:
        """Map request credentials to a tenant name: a matching bearer key
        wins, then an ``X-Tenant`` header naming a KEYLESS tenant (a keyed
        tenant must present its key — the header alone is not a
        credential), then the default tenant when anonymous access is
        allowed. Raises ``UnknownTenant`` otherwise — the 401 path."""
        if bearer is not None:
            name = self._by_key.get(bearer)
            if name is not None:
                return name
            raise UnknownTenant("unrecognized bearer key")
        if header is not None:
            st = self._t.get(header)
            if st is not None and st.cfg.key is None:
                return header
            if st is not None:
                raise UnknownTenant(
                    f"tenant {header!r} requires its bearer key"
                )
            raise UnknownTenant(f"unknown tenant {header!r}")
        if self.allow_anonymous and "default" in self._t:
            return "default"
        raise UnknownTenant(
            "no credentials and anonymous access is disabled"
        )

    # ------------------------------------------------------------ admission

    def admit_and_push(
        self, name: str, item, *, total_cap: Optional[int] = None
    ) -> None:
        """Atomic admission: every cap check and the enqueue happen under
        ONE lock hold, so N concurrent handlers can never overshoot a
        tenant's ``max_queued`` (or ``total_cap``, the ingress-wide
        bound) between check and push. Cap checks run BEFORE the token
        bucket is drawn — a request the queue refuses must not also cost
        its tenant a rate token."""
        with self._lock:
            st = self._t[name]
            if (
                st.cfg.max_queued is not None
                and len(st.queue) >= st.cfg.max_queued
            ):
                TENANT_THROTTLED.labels(tenant=name, reason="queue").inc()
                raise TenantQueueFull(name, len(st.queue), st.cfg.max_queued)
            if total_cap is not None:
                depth = sum(len(s.queue) for s in self._t.values())
                if depth >= total_cap:
                    raise GlobalQueueFull(depth, total_cap)
            if st.bucket is not None and not st.bucket.try_acquire():
                TENANT_THROTTLED.labels(tenant=name, reason="rate").inc()
                raise RateLimited(name, st.bucket.retry_after())
            if not st.queue:
                st.service = max(st.service, self._vt)
            st.queue.append(item)
            TENANT_QUEUED.labels(tenant=name).set(len(st.queue))

    # ------------------------------------------------------------ queueing

    def push(self, name: str, item) -> None:
        with self._lock:
            st = self._t[name]
            if not st.queue:
                # newly backlogged: lift to the virtual time so service
                # "saved up" while idle cannot fund a later monopoly
                st.service = max(st.service, self._vt)
            st.queue.append(item)
            TENANT_QUEUED.labels(tenant=name).set(len(st.queue))

    def push_front(self, name: str, item) -> None:
        """Return an item the dispatcher could not place (backend
        momentarily full) to the head of its tenant's queue — no
        re-admission checks, the request already passed them."""
        with self._lock:
            st = self._t[name]
            st.queue.appendleft(item)
            TENANT_QUEUED.labels(tenant=name).set(len(st.queue))

    def pop(self) -> Optional[Tuple[str, object]]:
        """Dispatch order: the backlogged tenant with the least normalized
        accumulated service; FIFO within the tenant. None when empty."""
        with self._lock:
            best: Optional[str] = None
            for name, st in self._t.items():
                if not st.queue:
                    continue
                if best is None or st.service < self._t[best].service:
                    best = name
            if best is None:
                return None
            st = self._t[best]
            self._vt = max(self._vt, st.service)
            item = st.queue.popleft()
            TENANT_QUEUED.labels(tenant=best).set(len(st.queue))
            return best, item

    def remove(self, name: str, item) -> bool:
        """Drop a specific queued item (deadline shed, client gone while
        queued). True if it was still queued."""
        with self._lock:
            st = self._t[name]
            try:
                st.queue.remove(item)
            except ValueError:
                return False
            TENANT_QUEUED.labels(tenant=name).set(len(st.queue))
            return True

    def sweep(self, predicate) -> list:
        """Remove and return every queued ``(tenant, item)`` for which
        ``predicate(item)`` is true — the ingress sheds deadline-expired
        entries here instead of letting them time out in queue."""
        out = []
        with self._lock:
            for name, st in self._t.items():
                if not st.queue:
                    continue
                keep = deque()
                for item in st.queue:
                    if predicate(item):
                        out.append((name, item))
                    else:
                        keep.append(item)
                if len(keep) != len(st.queue):
                    st.queue = keep
                    TENANT_QUEUED.labels(tenant=name).set(len(keep))
        return out

    # ------------------------------------------------------------ service

    def charge(self, name: str, tokens: int, kind: str = "decode") -> None:
        """Add observed service: ``tokens`` of ``kind`` (prefill at
        dispatch, decode as the stream commits), normalized by the
        tenant's weight for scheduling."""
        if tokens <= 0:
            return
        st = self._t[name]
        with self._lock:
            st.service += tokens / st.cfg.weight
        TENANT_SERVICE.labels(tenant=name, kind=kind).inc(tokens)

    def service_of(self, name: str) -> float:
        with self._lock:
            return self._t[name].service

    def depth(self, name: Optional[str] = None) -> int:
        with self._lock:
            if name is not None:
                return len(self._t[name].queue)
            return sum(len(st.queue) for st in self._t.values())
