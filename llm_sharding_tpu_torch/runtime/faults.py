"""Deterministic fault injection for the serving stack's resilience layer:
the port's own copy of ``llm_sharding_tpu/runtime/faults.py`` (whole:
every site name, ``FaultSpec``, ``FaultPlan``, the fault types,
``is_transient`` and ``backoff_delays``). That module is stdlib + numpy,
but importing it pulls jax in through ``llm_sharding_tpu/runtime/__init__.py``.
What differs: the plan's lock comes from the port's ``named_lock``
(``faults.plan``), the ``server_faults_injected_total`` family lives in
the port's registry, and ``is_transient`` never classes a sticky CUDA
error as transient.

``PipelineServer(fault_plan=plan)`` calls ``plan.check(site)`` (optionally
keyed, e.g. by request id) on every pass through a named site, and the
plan raises ``TransientFault`` or ``PermanentFault`` according to its
specs. Triggering is by explicit per-site call index, a "from this call
on" threshold, and/or a seeded per-spec RNG rate — all fully
deterministic given the same call sequence, so a chaos test can assert
token-exactness against the fault-free run. The port's server checks
``admit_dispatch``, ``chunk_dispatch``, ``log_fetch``, ``request_apply``
and ``snapshot_write``; the fleet ``replica_step`` and ``kv_handoff``, the
ingress ``http_request`` and ``slow_client``, and a context-parallel
server and the disagg hand-off ``cp_shard_stream``, once per owner shard
of a block stream.

The retry policy lives next to it: the server wraps dispatch and fetch in
bounded retry-with-backoff, retrying exactly the errors ``is_transient``
admits (injected transients plus any caller-registered exception types).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

from ..analysis.lockorder import named_lock
from ..obs.metrics import REGISTRY

M_FAULTS_INJECTED = REGISTRY.counter(
    "server_faults_injected_total",
    "Faults raised by the active FaultPlan, by site and kind",
    labels=("site", "kind"),
)

#: The sites the serving stack checks. Plans may name a subset; naming an
#: unknown site raises at plan construction (a typo'd site would otherwise
#: silently never fire and the chaos test would pass vacuously).
SITES = (
    "admit_dispatch",  # one batch admission (one-shot or chunked prefill)
    "chunk_dispatch",  # one decode chunk / speculative verify dispatch
    "log_fetch",       # consuming one prefetched device→host log read
    "request_apply",   # one committed token application (keyed by req id)
    "snapshot_write",  # one auto-snapshot write
    "replica_step",    # one router-driven replica step (keyed by the
    #                    replica's device-group index) — a permanent fault
    #                    here simulates the whole replica vanishing and
    #                    drives the ReplicatedServer failover path
    "http_request",    # one HTTP request entering the ingress (keyed by
    #                    tenant name) — a fault here is infrastructure
    #                    trouble at the front door; the ingress answers
    #                    503 + Retry-After instead of crashing the handler
    "slow_client",     # one SSE write to a streaming client (keyed by
    #                    tenant name) — a fault here simulates the client
    #                    stalling/vanishing mid-stream; the ingress must
    #                    cancel the row and free its KV blocks exactly
    #                    like a real BrokenPipeError
    "kv_handoff",      # one prefill→decode KV hand-off attempt (keyed by
    #                    request id) — transient defers the hand-off to the
    #                    next sweep (retried), permanent falls back to
    #                    decoding where the request already lives; token
    #                    identity must hold on every path
    "cp_shard_stream", # one per-shard block-stream pass at cp>1 (keyed by
    #                    the owner-shard index) — a fault here simulates one
    #                    chip of a context-parallel arena failing to serve
    #                    its slice of a streamed prefix; transient defers
    #                    the hand-off (retried), permanent falls back to
    #                    re-prefill on the destination
)


class InjectedFault(RuntimeError):
    """A fault raised by a ``FaultPlan`` at an armed site."""

    transient = False

    def __init__(self, site: str, nth: int, key=None):
        self.site = site
        self.nth = nth  # which pass through the site fired (0-based)
        self.key = key
        tag = f" key={key!r}" if key is not None else ""
        super().__init__(
            f"injected {type(self).__name__} at {site}[{nth}]{tag}"
        )


class TransientFault(InjectedFault):
    """Recoverable: the retry policy is expected to absorb it."""

    transient = True


class PermanentFault(InjectedFault):
    """Unrecoverable: retries must give up and containment must kick in."""

    transient = False


def sticky_device_error(err: BaseException) -> bool:
    """A CUDA error that poisons the process's context (an illegal address,
    a launch failure): every later launch in this process fails too, so no
    retry can absorb it. torch raises these as ``torch.AcceleratorError``
    (a ``RuntimeError``) or as a ``RuntimeError`` whose message names the
    CUDA error; matched by name so this module needs no torch."""
    return type(err).__name__ == "AcceleratorError" or "CUDA error" in str(err)


def is_transient(err: BaseException, extra: Tuple[type, ...] = ()) -> bool:
    """The retry policy's admit test: injected transients, plus any
    caller-registered real exception types (e.g. a deployment that knows its
    link raises ``OSError`` on a dropped connection). Follows the
    ``__cause__`` chain — the serving stack wraps device-read failures in a
    tagged ``RuntimeError`` and the classification must see through it. A
    sticky CUDA error (``sticky_device_error``) is never transient, even
    when its type is registered: the process cannot serve again, and the
    recovery is a restore from the last snapshot in a new process."""
    chain: list = []
    e: Optional[BaseException] = err
    while e is not None and all(e is not c for c in chain):
        chain.append(e)
        e = e.__cause__
    if any(sticky_device_error(c) for c in chain):
        return False
    for c in chain:
        if isinstance(c, InjectedFault):
            return c.transient
        if extra and isinstance(c, extra):
            return True
    return False


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One armed failure mode.

    A spec fires on a pass when any trigger matches: ``at`` (those exact
    0-based passes through the site, counted per ``(site, key)``),
    ``from_call`` (every pass at or past that index — the stuck-device
    case), or ``rate`` (per-pass probability from this spec's own seeded
    RNG stream). ``key`` restricts the spec to ``check(site, key=...)``
    calls with that key (the per-request fault handle). ``max_fires`` caps
    total fires — a transient burst that eventually clears."""

    site: str
    kind: str = "transient"  # "transient" | "permanent"
    at: Tuple[int, ...] = ()
    from_call: Optional[int] = None
    rate: float = 0.0
    key: object = None
    max_fires: Optional[int] = None

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(
                f"unknown fault site {self.site!r}; known sites: {SITES}"
            )
        if self.kind not in ("transient", "permanent"):
            raise ValueError(f"kind must be transient|permanent, {self.kind!r}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")
        object.__setattr__(self, "at", tuple(int(i) for i in self.at))

    def _hits(self, n: int, rng) -> bool:
        return (
            n in self.at
            or (self.from_call is not None and n >= self.from_call)
            or (self.rate > 0.0 and rng.random() < self.rate)
        )


class FaultPlan:
    """A seedable, deterministic set of ``FaultSpec``s.

    Thread-safe (the serving loop and request threads may both cross
    sites). Determinism: per-site/per-key call counters plus one independent
    seeded RNG stream per rate-spec — identical call sequences produce
    identical fault sequences, which is what lets the chaos suite assert
    greedy token-exactness under injected transients."""

    def __init__(self, specs: Iterable[FaultSpec], seed: int = 0):
        self.specs = tuple(specs)
        self.seed = seed
        self._rngs = [
            np.random.default_rng(np.random.SeedSequence([seed, i]))
            for i in range(len(self.specs))
        ]
        self._calls: collections.Counter = collections.Counter()
        self._fires: collections.Counter = collections.Counter()
        self._lock = named_lock("faults.plan")

    # ------------------------------------------------------------ builders

    @classmethod
    def transient_at(cls, site: str, *indices: int, key=None) -> "FaultPlan":
        """Transient faults on exactly those passes through ``site``."""
        return cls([FaultSpec(site, "transient", at=indices, key=key)])

    @classmethod
    def permanent(cls, site: str, *, key=None, start: int = 0) -> "FaultPlan":
        """A fault firing on every pass from ``start`` on, never clearing —
        the stuck-device / poisoned-request case retries cannot absorb."""
        return cls([FaultSpec(site, "permanent", from_call=start, key=key)])

    @classmethod
    def rates(cls, seed: int = 0, **site_rates: float) -> "FaultPlan":
        """Transient faults at a per-call probability per site, e.g.
        ``FaultPlan.rates(seed=3, chunk_dispatch=0.1, log_fetch=0.05)`` —
        the bench's fixed-fault-rate scenario."""
        return cls(
            [FaultSpec(s, "transient", rate=r)
             for s, r in sorted(site_rates.items())],
            seed,
        )

    # ------------------------------------------------------------ checking

    def check(self, site: str, key=None) -> None:
        """Count one pass through ``site`` (optionally keyed) and raise the
        armed fault, if any. Each call advances the (site, key) counter even
        when multiple specs watch the site, so a retry of a faulted call
        re-checks under a fresh index and a ``transient_at`` burst clears."""
        with self._lock:
            n = self._calls[(site, key)]
            self._calls[(site, key)] = n + 1
            for i, spec in enumerate(self.specs):
                if spec.site != site:
                    continue
                if spec.key is not None and spec.key != key:
                    continue
                if (
                    spec.max_fires is not None
                    and self._fires[i] >= spec.max_fires
                ):
                    continue
                if not spec._hits(n, self._rngs[i]):
                    continue
                self._fires[i] += 1
                M_FAULTS_INJECTED.labels(site=site, kind=spec.kind).inc()
                cls_ = TransientFault if spec.kind == "transient" \
                    else PermanentFault
                raise cls_(site, n, key)

    def stats(self) -> dict:
        """Pass/fire tallies — for test assertions and the bench's
        fault-scenario report."""
        with self._lock:
            return {
                "calls": {
                    s + (f"[{k!r}]" if k is not None else ""): int(c)
                    for (s, k), c in sorted(
                        self._calls.items(), key=lambda kv: str(kv[0])
                    )
                },
                "total_fires": int(sum(self._fires.values())),
            }


def backoff_delays(
    retries: int, base_s: float, max_s: float = 1.0
) -> Sequence[float]:
    """The bounded exponential-backoff schedule the server sleeps between
    retry attempts: base, 2·base, 4·base, … capped at ``max_s``."""
    return tuple(
        min(base_s * (2 ** i), max_s) for i in range(max(retries, 0))
    )
