"""Data-parallel continuous batching: replica servers behind a SUPERVISED
router (the port of ``llm_sharding_tpu/runtime/replicated.py``, whole).

A serving daemon scales out as D independent replicas with a request
router in front: each replica is a full ``Engine`` + ``PipelineServer``
(continuous batching, chunked prefill, per-request sampling, stop strings,
cancellation, the embedding entry), and nothing couples them.

Where a replica runs: as the JAX router, replica ``d`` takes the ``d``-th
of ``data_parallel`` equal, disjoint groups of ``devices``, in order; a
group is the stage device list of the replica's engine (``num_stages`` /
``placement``, as ``Engine`` takes them), and entries may repeat.
``devices=None`` puts every stage of every replica on the default device
(the GPU), which is how one card serves D replicas: they share its memory
and its stream, and the router steps them in turn on one thread, so D
replicas over the same rows sum to no more than one replica's throughput
(each step is mostly host dispatch). The weights are kept once as CPU
tensors, and each replica stages its own copy onto its devices (a CPU
replica's copy is the host tensors themselves).

Replica SUPERVISION (what turns D replicas into one endpoint that survives
losing any of them):

- **failure detection**: the router watches each replica for (a) a
  ``step()`` that raises (including an injected ``replica_step`` fault —
  ``runtime/faults.py`` — keyed by the replica's group index) and (b)
  containment events (``PipelineServer.containment_events``) crossing
  ``failure_threshold`` inside ``failure_window_s``;
- **failover**: a failed replica is QUARANTINED (no new admissions, no
  more steps), every live row and queued request is ``extract``ed as
  host-side ``RequestState`` and ``adopt``ed onto survivors — greedy
  continuation is token-identical to an unfaulted run, sampled
  continuation resumes from the carried generator state, prefix-bound
  rows re-resolve their local handle through the
  ``ReplicatedPrefixHandle.per_server`` map; a request no survivor can
  take fails with the typed ``RequestFailed``. The dead replica is then
  closed and its group freed;
- **elasticity**: ``drain(d)`` electively migrates a replica's work out
  and closes it (scale-down drops zero streams); ``spawn_replica()``
  brings a fresh engine+server up on a freed group, re-staging weights
  from the host copy (scale-up); ``min_replicas`` guards drain;
- **health-aware routing**: ``_pick`` only routes to SERVING replicas
  while any exist, falling back in severity order otherwise;
- **observability**: ``server_replica_failovers/drains/spawns_total``,
  ``server_requests_migrated_total{outcome}`` and the per-replica one-hot
  ``server_replica_state{replica,state}`` gauge (``obs/metrics.py``).
"""

from __future__ import annotations

import collections
import logging
import os
import time
import weakref
from typing import Any, Iterator, Optional

import torch

from ..analysis.lockorder import named_lock
from ..device import resolve_device
from ..parallel.pipeline import map_params
from ..obs.metrics import (
    REPLICA_DRAINS, REPLICA_FAILOVERS, REPLICA_SPAWNS, REQUESTS_MIGRATED,
    set_replica_state,
)
from ..obs.trace import TraceWriter, emit_span
from .engine import Engine
from .faults import is_transient
from .server import (
    PipelineServer, PrefixHandle, Request, RequestFailed, ServerClosed,
    _HEALTH_SEVERITY,
)

logger = logging.getLogger(__name__)


class ReplicatedPrefixHandle:
    """A shared prefix prefilled on EVERY replica (each replica's handle
    lives in its own arena). ``submit(prefix=...)`` resolves it to the
    routed replica's local handle.

    Replicas spawned AFTER the handle was built are not covered by it —
    the router routes covered requests only among covered replicas, and a
    migration targeting an uncovered replica skips it."""

    __slots__ = ("per_server", "__weakref__")

    def __init__(self, per_server: dict):
        # keyed by the server OBJECT (not id()): keeps the replicas the
        # handle was built for alive, so a recycled address can never alias
        # a stale handle onto a new server
        self.per_server = per_server  # PipelineServer → PrefixHandle


class ReplicatedServer:
    """D replica ``PipelineServer``s + a health-aware least-loaded router
    with replica supervision (failure detection, live request migration,
    drain/spawn elasticity). The public surface mirrors
    ``PipelineServer``."""

    def __init__(
        self,
        cfg,
        params: Any,
        *,
        data_parallel: int,
        num_stages: Optional[int] = None,
        tensor_parallel: int = 1,
        placement=None,
        devices: Optional[list] = None,
        tokenizer: Any = None,
        failure_threshold: int = 3,
        failure_window_s: float = 60.0,
        min_replicas: int = 1,
        global_index: Optional[bool] = None,
        **serve_kwargs,
    ):
        if data_parallel < 1:
            raise ValueError("data_parallel must be >= 1")
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}"
            )
        if failure_window_s <= 0:
            raise ValueError(
                f"failure_window_s must be > 0, got {failure_window_s}"
            )
        if not 0 <= min_replicas <= data_parallel:
            raise ValueError(
                f"min_replicas must be in [0, data_parallel], got "
                f"{min_replicas} with data_parallel={data_parallel}"
            )
        # a context-parallel replica (serve_kwargs cp > 1) spans cp × stages
        # devices of its group (JAX ``replicated.py``: dp × cp × stages)
        cp = int(serve_kwargs.get("cp", 1) or 1)
        if devices is None:
            per = placement.num_stages if placement is not None else (num_stages or 1)
            devices = [resolve_device(None)] * (data_parallel * per * tensor_parallel * cp)
        devices = [resolve_device(d) for d in devices]
        if len(devices) % data_parallel:
            raise ValueError(
                f"{len(devices)} devices not divisible into "
                f"{data_parallel} replica groups"
            )
        # the weights kept ONCE on the host for the daemon's lifetime: every
        # replica stages its own copy from them, spawn_replica included
        self._host_params = map_params(lambda t: t.detach().to("cpu"), params)
        # one JSONL trace file PER REPLICA (suffix .r<d>, d = group index):
        # a shared file would interleave the replicas' spans with no way to
        # attribute them. ROUTER-level events (failover/drain/spawn
        # decisions, per-request migrations, disagg hand-offs) get their own
        # .router file; every span carries a trace_id where applicable, so
        # trace-report merges the set back into per-request trees.
        self._trace_path = serve_kwargs.pop("trace_path", None)
        self._router_trace = (
            TraceWriter(f"{self._trace_path}.router")
            if self._trace_path else None
        )
        # auto-snapshots likewise: one directory per replica, or D servers
        # would race the same atomic rename
        self._snapshot_path = serve_kwargs.pop("snapshot_path", None)
        # disk KV pools likewise: one subdirectory per GROUP, keyed by the
        # stable group index, so a replica re-spawned on group d ADOPTS its
        # predecessor's pool
        self._disk_pool_dir = serve_kwargs.pop("disk_pool_dir", None)
        self._cfg = cfg
        self._num_stages = num_stages
        # every replica is a pp×tp server: dp×pp×tp serving (JAX
        # ``replicated.py:179``)
        self._tp = int(tensor_parallel)
        self._placement = placement
        self._tokenizer = tokenizer
        self._serve_kwargs = dict(serve_kwargs)
        # the router shares the replicas' fault plan for the replica-level
        # crash site (``replica_step``, keyed by group index)
        self._fault_plan = serve_kwargs.get("fault_plan")
        self.failure_threshold = int(failure_threshold)
        self.failure_window_s = float(failure_window_s)
        self.min_replicas = int(min_replicas)
        self.data_parallel = data_parallel
        # fixed groups; the group index is the replica's stable identity
        # across drain/spawn cycles (metrics label, CLI :drain N)
        group = len(devices) // data_parallel
        self._groups = [devices[d * group : (d + 1) * group] for d in range(data_parallel)]
        self.engines: list[Engine] = []
        self.servers: list[PipelineServer] = []
        self._by_group: dict[int, PipelineServer] = {}
        self._group_of: dict[PipelineServer, int] = {}
        self._failures: dict[PipelineServer, collections.deque] = {}
        self._seen_contained: dict[PipelineServer, int] = {}
        self._gauge_state: dict[int, str] = {}
        # one lock serializes router mutations (routing tables, ownership,
        # the servers list) against each other — a cancel can never observe
        # a request mid-migration. Re-entrant: stream() → step() → failover.
        self._lock = named_lock("replica.router", "rlock")
        # live replicated prefix handles: migration re-resolves a request's
        # source-local handle to the target's through these (weak: handles
        # die with their callers)
        self._rhandles: "weakref.WeakSet[ReplicatedPrefixHandle]" = (
            weakref.WeakSet()
        )
        # cluster-global radix index: replicas with a prefix cache publish
        # their tree contents (insert/demote/promote/evict) into one
        # token-hash → {replica, tier} map and _pick consults IT instead of
        # probing every replica's tree under its mutex. None (auto) = on
        # whenever any replica caches; False = no cluster cache-aware
        # routing at all (index AND per-replica probing).
        self._gindex_opt = global_index
        self._gindex = None
        for d in range(data_parallel):
            self._spawn_on_group(d)
        self._rr = 0
        # request → owning replica (weak keys: entries vanish with requests)
        self._owner: "weakref.WeakKeyDictionary[Request, PipelineServer]" = (
            weakref.WeakKeyDictionary()
        )

    # ------------------------------------------------------- replica pool

    def _spawn_on_group(self, d: int) -> PipelineServer:
        """Bring a replica up on group ``d``: a fresh engine staged from the
        host weights (one device: loaded straight onto it; else the stages
        over the group) + a fresh server with the router's serve kwargs.
        Registers it for routing/stepping/supervision."""
        group = self._groups[d]
        if (len(group) == 1 and self._num_stages is None and self._placement is None
                and self._tp == 1):
            eng = Engine(self._cfg, map_params(lambda t: t.to(group[0]), self._host_params))
        else:
            # a cp replica's group holds cp × stages devices: its stage count
            # is the router's, its cp grid the group (PipelineServer's mesh)
            stages = self._num_stages
            if stages is None and self._placement is None and self._serve_kwargs.get("cp", 1) > 1:
                stages = 1
            eng = Engine(self._cfg, self._host_params, num_stages=stages,
                         placement=self._placement, devices=group, tensor_parallel=self._tp)
        eng.tokenizer = self._tokenizer
        srv = eng.serve(
            trace_path=(
                f"{self._trace_path}.r{d}" if self._trace_path else None
            ),
            snapshot_path=(
                f"{self._snapshot_path}.r{d}" if self._snapshot_path else None
            ),
            disk_pool_dir=(
                os.path.join(self._disk_pool_dir, f"r{d}")
                if self._disk_pool_dir else None
            ),
            **self._serve_kwargs,
        )
        srv._span_src = f"r{d}"  # flight-recorder spans name their replica
        srv.stepline.name = f"r{d}"  # /debugz step rings likewise
        self._wire_index(srv, d)
        self.engines.append(eng)
        self.servers.append(srv)
        self._by_group[d] = srv
        self._group_of[srv] = d
        self._failures[srv] = collections.deque()
        self._seen_contained[srv] = srv.containment_events
        self._set_replica_gauge(d, srv.health)
        return srv

    def _wire_index(self, srv: PipelineServer, d: int) -> None:
        """Attach a caching replica to the cluster index: build the index
        on first need (the replica's block size defines the hash
        granularity), wire the tree's publish hook under the replica's
        stable group key, and announce any pre-existing contents (snapshot
        restore, adopted disk pool)."""
        if self._gindex_opt is False or getattr(srv, "_radix", None) is None:
            return
        if self._gindex is None:
            from .global_index import GlobalRadixIndex

            self._gindex = GlobalRadixIndex(srv.kv_block_size)
        key, gindex = f"g{d}", self._gindex
        srv._radix.publish = (
            lambda ids, tier, _k=key, _ix=gindex: _ix.publish(_k, ids, tier)
        )
        srv._radix.announce_all()

    def _retire(self, srv: PipelineServer) -> int:
        """Remove a replica from routing, stepping and supervision (it
        receives no new admissions and its group is spawnable again once
        the caller closes it). Returns the freed group index."""
        d = self._group_of.pop(srv)
        if self._gindex is not None:
            # the fleet must stop routing toward a dead tree NOW; the
            # retiring server itself stops publishing (its late releases
            # during migration would otherwise re-insert entries)
            rad = getattr(srv, "_radix", None)
            if rad is not None:
                rad.publish = None
            self._gindex.drop_replica(f"g{d}")
        self._by_group.pop(d, None)
        i = self.servers.index(srv)
        del self.servers[i]
        del self.engines[i]
        self._failures.pop(srv, None)
        self._seen_contained.pop(srv, None)
        return d

    def _set_replica_gauge(self, d: int, state: str) -> None:
        if self._gauge_state.get(d) != state:
            self._gauge_state[d] = state
            set_replica_state(d, state)

    def _decision(self, name: str, req=None, dur_s=None, **fields):
        """Router-level span (failover/drain/spawn decisions, per-request
        migrations): flight recorder + the .router JSONL file. ``req``
        attributes the span to the request's trace like the servers'
        per-stage spans."""
        if req is not None:
            fields.setdefault("id", req.id)
        emit_span(
            self._router_trace, name, dur_s=dur_s,
            parent_of=None if req is None else req.trace,
            src="router", **fields,
        )

    # ------------------------------------------------------------------ API

    def _pick(
        self, covered: Optional[set] = None, prompt_ids=None,
    ) -> PipelineServer:
        """Health-aware least-loaded routing: only SERVING replicas receive
        new traffic while at least one exists (a DEGRADED replica must not
        win least-loaded ties); when none are SERVING, fall back in
        severity order to the least-bad class. With prefix caches and a
        prompt, the WARMEST replicas win first: one cluster-index lookup
        scores every candidate by (match depth, tier warmth) — deepest
        cached prefix first, hbm > host > disk on depth ties (the per-tree
        probe remains only as a fallback while the index is unbuilt; ties,
        and cold prompts, fall through to load). Least-loaded (queued +
        in-flight) within the class; round-robin ties. ``covered``
        restricts candidates (prefix routing). Raises ``ServerClosed``
        when no replica can take the request."""
        with self._lock:
            cands = [
                s for s in self.servers
                if not s._closed and (covered is None or s in covered)
            ]
            if not cands:
                raise ServerClosed(
                    "no live replica can accept this request (all "
                    "quarantined/closed"
                    + (" or not covered by the prefix handle" if covered
                       is not None else "") + ")"
                )
            serving = [
                s for s in cands if _HEALTH_SEVERITY[s.health] == 0
            ]
            if not serving:
                best = min(_HEALTH_SEVERITY[s.health] for s in cands)
                serving = [
                    s for s in cands if _HEALTH_SEVERITY[s.health] == best
                ]
            if prompt_ids is not None and self._gindex is not None:
                keys = {s: f"g{self._group_of[s]}" for s in serving}
                scored = self._gindex.scores(prompt_ids, keys.values())
                best = max(scored[keys[s]] for s in serving)
                if best > (0, 0):
                    serving = [
                        s for s in serving if scored[keys[s]] == best
                    ]
            elif (
                prompt_ids is not None and self._gindex_opt is not False
                and any(s._radix is not None for s in serving)
            ):
                matches = {
                    s: s.radix_match_tokens(prompt_ids) for s in serving
                }
                warmest = max(matches.values())
                if warmest > 0:
                    serving = [
                        s for s in serving if matches[s] == warmest
                    ]
            loads = {s: self._load(s) for s in serving}
            lo = min(loads.values())
            n = len(self.servers)
            for off in range(n):
                i = (self._rr + off) % n
                s = self.servers[i]
                if s in loads and loads[s] == lo:
                    self._rr = (i + 1) % n
                    return s
            return serving[0]  # unreachable

    @staticmethod
    def _load(s: PipelineServer) -> int:
        return len(s._queue) + sum(
            r is not None and not r.done for r in s._req
        )

    def prefill_prefix(self, prefix_ids) -> ReplicatedPrefixHandle:
        """Prefill a shared prefix once PER REPLICA (a system prompt is
        served from every replica, so each caches its own copy). The router
        keeps a weak registry of live handles so a migrated prefix-bound
        request can re-resolve its replica-local handle."""
        with self._lock:
            h = ReplicatedPrefixHandle(
                {s: s.prefill_prefix(prefix_ids) for s in self.servers}
            )
            self._rhandles.add(h)
        return h

    def release_prefix(self, handle: ReplicatedPrefixHandle) -> None:
        """Release the per-replica handles (paged replicas return the
        prefix's pinned blocks to their pools once the last mapping row
        finishes; dense replicas no-op)."""
        if not isinstance(handle, ReplicatedPrefixHandle):
            raise ValueError(
                "release_prefix takes the ReplicatedPrefixHandle returned "
                "by ReplicatedServer.prefill_prefix"
            )
        with self._lock:
            self._rhandles.discard(handle)
            for s, h in handle.per_server.items():
                s.release_prefix(h)

    def submit(self, prompt_ids, max_new_tokens: int = 128, **kw) -> Request:
        with self._lock:
            pfx = kw.get("prefix")
            covered = None
            if isinstance(pfx, ReplicatedPrefixHandle):
                covered = {
                    s for s in self.servers if s in pfx.per_server
                }
                if not covered:
                    raise ValueError(
                        "no live replica holds this prefix (its replicas "
                        "were drained/failed over, or the handle belongs "
                        "to a different ReplicatedServer) — re-run "
                        "prefill_prefix"
                    )
            elif isinstance(pfx, PrefixHandle):
                raise ValueError(
                    "a bare PrefixHandle is bound to one replica's arena "
                    "— use ReplicatedServer.prefill_prefix"
                )
            s = self._pick(
                covered,
                # prefix-cache-aware routing only applies to plain prompts
                # (handle-bound suffixes carry their own shared KV)
                prompt_ids=None if pfx is not None else prompt_ids,
            )
            if covered is not None:
                kw["prefix"] = pfx.per_server[s]
            req = s.submit(prompt_ids, max_new_tokens, **kw)
            self._owner[req] = s
            return req

    def submit_embedding(
        self, prompt_embeds, max_new_tokens: int = 128, **kw
    ) -> Request:
        with self._lock:
            s = self._pick()
            req = s.submit_embedding(prompt_embeds, max_new_tokens, **kw)
            self._owner[req] = s
            return req

    def embed_prompt(self, prompt_ids):
        """Embedding-entry helper (all replicas share the same weights)."""
        return self.engines[0].embed_prompt(prompt_ids)

    # -------------------------------------------------------- supervision

    def step(self) -> bool:
        """One supervised step on every live replica, in turn.

        Supervision per replica: an injected ``replica_step`` fault (keyed
        by group index) or a raising ``step()`` classifies the replica —
        transient signals count against the failure window, a permanent
        fault or an escaped exception fails it over immediately; a clean
        step samples the replica's containment-event delta against the
        same window. A failed-over replica's requests migrate to survivors
        within this call."""
        progressed = False
        with self._lock:
            for s in list(self.servers):
                d = self._group_of.get(s)
                if d is None:
                    continue  # retired by an earlier failover this sweep
                if self._fault_plan is not None:
                    try:
                        self._fault_plan.check("replica_step", key=d)
                    except Exception as e:  # noqa: BLE001 — classified below
                        progressed = True
                        if is_transient(e):
                            logger.warning(
                                "replica %d: transient step fault %r", d, e
                            )
                            if self._note_failures(s, 1):
                                self._fail_replica(s, e)
                        else:
                            self._fail_replica(s, e)
                        continue
                try:
                    progressed |= s.step()
                except Exception as e:  # noqa: BLE001 — a step that escapes
                    # the server's own containment means the replica is gone
                    progressed = True
                    self._fail_replica(s, e)
                    continue
                delta = s.containment_events - self._seen_contained[s]
                if delta:
                    self._seen_contained[s] = s.containment_events
                    if self._note_failures(s, delta):
                        self._fail_replica(s, RuntimeError(
                            f"replica {d} crossed the containment "
                            f"threshold ({self.failure_threshold} events "
                            f"within {self.failure_window_s:g}s)"
                        ))
                        continue
                self._set_replica_gauge(d, s.health)
        return progressed

    def _note_failures(self, s: PipelineServer, n: int) -> bool:
        """Record ``n`` failure events against the replica's sliding window;
        True when the threshold is crossed (the replica should fail over)."""
        rec = self._failures[s]
        now = time.perf_counter()
        rec.extend([now] * n)
        while rec and now - rec[0] > self.failure_window_s:
            rec.popleft()
        return len(rec) >= self.failure_threshold

    def _fail_replica(self, s: PipelineServer, err: BaseException) -> None:
        """FAILOVER: quarantine the replica (no admissions, no steps),
        migrate every live request to survivors, close it, free its group."""
        d = self._group_of.get(s)
        if d is None:
            return  # already failed over
        logger.error(
            "replica %d classified FAILED (%r): quarantining and migrating "
            "its live requests", d, err,
        )
        t0 = time.perf_counter()
        REPLICA_FAILOVERS.inc()
        self._set_replica_gauge(d, "QUARANTINED")
        self._retire(s)
        moved, failed = self._migrate_all(s, err)
        try:
            s.close()
        except Exception:  # noqa: BLE001 — the device may be unusable; the
            # host-side teardown already ran inside close() before any
            # device work could raise
            logger.exception("close of failed replica %d raised", d)
        self._set_replica_gauge(d, "OFFLINE")
        self._decision(
            "failover", dur_s=time.perf_counter() - t0, replica=d,
            error=repr(err)[:200], moved=moved, failed=failed,
        )
        logger.warning(
            "replica %d failed over: %d request(s) migrated, %d failed; "
            "%d replica(s) live", d, moved, failed, len(self.servers),
        )

    def _migrate_all(
        self, src: PipelineServer, cause: Optional[BaseException]
    ) -> tuple:
        """Move every live request off ``src``: in-flight rows first (they
        are the oldest work), then the queue. Iterated in reverse with
        front-insertion on the target, so relative order is preserved and
        migrated requests admit ahead of fresh traffic. Returns
        ``(moved, failed)``."""
        victims = [
            r for r in src._req if r is not None and not r.done
        ] + [r for r in list(src._queue) if not r.done]
        moved = failed = 0
        for req in reversed(victims):
            t0 = time.perf_counter()
            try:
                # failover (cause set) must NOT settle: the dead replica's
                # logs would convert migratable requests into contained
                # failures — its in-flight tokens replay on the adopter,
                # token-identically. Elective drain() settles before
                # calling here, and settle=True keeps any entry landed
                # between then and this extract.
                st = src.extract(req, settle=cause is None)
            except Exception as e:  # noqa: BLE001 — classified below
                if req.done and req.error is None:
                    # the settle landed this request's final in-flight
                    # tokens: it COMPLETED — nothing to migrate or fail
                    continue
                # even extraction failed: the request cannot be saved,
                # fail it typed
                src._fail_request(req, e)
                REQUESTS_MIGRATED.labels(outcome="failed").inc()
                failed += 1
                continue
            rh = None
            if st.prefix is not None:
                rh = next(
                    (h for h in self._rhandles
                     if h.per_server.get(src) is st.prefix),
                    None,
                )
            targets = self._migration_targets(st, rh)
            adopted = False
            last_err: Optional[BaseException] = cause
            for t in targets:
                try:
                    t.adopt(
                        st, req,
                        prefix=(
                            None if st.prefix is None else rh.per_server[t]
                        ),
                        front=True,
                    )
                except (ValueError, RuntimeError) as e:
                    last_err = e
                    continue
                self._owner[req] = t
                REQUESTS_MIGRATED.labels(outcome="ok").inc()
                self._decision(
                    "migrate", req=req, dur_s=time.perf_counter() - t0,
                    outcome="ok", dst=self._group_of.get(t, -1),
                )
                adopted = True
                moved += 1
                break
            if not adopted:
                src._fail_request(req, RequestFailed(
                    f"request {req.id} could not be migrated off its "
                    f"failed/draining replica: "
                    + ("no surviving replica can adopt it"
                       if last_err is None else repr(last_err)),
                    req,
                ))
                REQUESTS_MIGRATED.labels(outcome="failed").inc()
                self._decision("migrate", req=req, outcome="failed")
                failed += 1
        return moved, failed

    def _migration_targets(self, st, rh) -> list:
        """Candidate adopters for one extracted request, best first:
        live, prefix-covered (when the request is handle-bound),
        least-loaded. A hook — the disaggregated router overrides the
        ORDERING (role-affine placement) but never the candidate set, so
        correctness (any live replica can adopt) is inherited."""
        return sorted(
            (t for t in self.servers
             if not t._closed
             and (st.prefix is None
                  or (rh is not None and t in rh.per_server))),
            key=self._load,
        )

    # --------------------------------------------------------- elasticity

    def drain(self, which) -> int:
        """Elective scale-down: stop admitting to the replica, migrate
        every live row and queued request to the other replicas (greedy
        continuations are identical, sampled ones resume their carried
        generator state), then ``close()`` it and free its group for a
        later ``spawn_replica()``. ``which`` is the replica's group index
        (the ``:drain N`` / stats label) or the server object. Returns the
        number of requests migrated. Refused (``ValueError``) when it
        would leave fewer than ``min_replicas`` live replicas."""
        with self._lock:
            if isinstance(which, PipelineServer):
                s = which if which in self._group_of else None
            else:
                s = self._by_group.get(int(which))
            if s is None:
                raise ValueError(
                    f"no live replica {which!r} (live groups: "
                    f"{sorted(self._by_group)})"
                )
            if len(self.servers) - 1 < self.min_replicas:
                raise ValueError(
                    f"drain refused: {len(self.servers) - 1} replica(s) "
                    f"would remain, below min_replicas="
                    f"{self.min_replicas}"
                )
            t0 = time.perf_counter()
            d = self._group_of[s]
            self._set_replica_gauge(d, "DRAINING")
            self._retire(s)  # no new admissions from here on
            # apply every landed-but-unapplied log first so the migrated
            # state carries all committed tokens (with inflight_steps > 1
            # this settles every overlapped dispatch); on failure the flush
            # is skipped — see _fail_replica — and the adopter regenerates
            # the in-flight tokens identically
            try:
                with s._mutex:
                    s._drain(0)
            except Exception:  # noqa: BLE001 — migrate from last applied
                logger.exception(
                    "drain: log flush on replica %d failed; migrating from "
                    "the last applied state", d,
                )
            moved, failed = self._migrate_all(s, None)
            try:
                s.close()
            except Exception:  # noqa: BLE001
                logger.exception("drain: close of replica %d raised", d)
            REPLICA_DRAINS.inc()
            self._decision(
                "drain", dur_s=time.perf_counter() - t0, replica=d,
                moved=moved, failed=failed,
            )
            self._set_replica_gauge(d, "OFFLINE")
            logger.info(
                "replica %d drained: %d migrated, %d failed; %d replica(s) "
                "live", d, moved, failed, len(self.servers),
            )
            return moved

    def least_loaded_group(self) -> Optional[int]:
        """Group index of the live replica with the least work (queued +
        in-flight) — the autoscaler's drain target, chosen so a scale-down
        migrates the fewest streams. None with no live replica."""
        with self._lock:
            if not self.servers:
                return None
            s = min(self.servers, key=self._load)
            return self._group_of.get(s)

    def spawn_replica(self) -> PipelineServer:
        """Elective scale-up: bring a fresh replica up on the lowest freed
        group (weights re-staged from the host copy the router kept).
        Raises ``ValueError`` when every group already runs a replica."""
        with self._lock:
            free = sorted(
                d for d in range(len(self._groups)) if d not in self._by_group
            )
            if not free:
                raise ValueError(
                    "no freed device group to spawn on (every group runs a "
                    "replica; drain one first)"
                )
            t0 = time.perf_counter()
            d = free[0]
            srv = self._spawn_on_group(d)
            REPLICA_SPAWNS.inc()
            self._decision("spawn", dur_s=time.perf_counter() - t0, replica=d)
            logger.info(
                "replica spawned on group %d; %d replica(s) live",
                d, len(self.servers),
            )
            return srv

    # ------------------------------------------------------------ serving

    def run_until_idle(self) -> None:
        while any(
            s._queue or s._any_active() or s._pending for s in self.servers
        ):
            self.step()

    def cancel(self, req: Request) -> bool:
        """Routed to the owning replica (``PipelineServer.cancel`` also
        verifies row ownership). Under the router lock so a cancel can
        never interleave with the request migrating between replicas."""
        with self._lock:
            s = self._owner.get(req)
            return s.cancel(req) if s is not None else False

    def stream(self, req: Request) -> Iterator[int]:
        """Stream one request's tokens, pumping EVERY replica (other
        replicas' requests keep decoding while this one streams). Token
        reads snapshot under the OWNING replica's mutex — re-resolved each
        iteration, because a failover/drain may migrate the request to
        another replica mid-stream (the token list is the same object).
        A request that FAILED raises the typed ``RequestFailed`` after its
        partial tokens, like ``PipelineServer.stream``."""
        idx = 0
        while True:
            owner = self._owner.get(req)
            if owner is not None:
                with owner._mutex:
                    batch = req.tokens[idx:]
                    done = req.done
                    error = req.error
            else:
                batch = req.tokens[idx:]
                done = req.done
                error = req.error
            for t in batch:
                yield t
            idx += len(batch)
            if done:
                if error is not None:
                    raise RequestFailed(
                        f"request {req.id} failed: {error}", req
                    ) from error
                return
            self.step()

    def snapshot(self) -> list:
        """Checkpoint every live replica's serving state (see
        ``PipelineServer.snapshot``): a list of per-replica snapshots, in
        replica order."""
        return [s.snapshot() for s in self.servers]

    @classmethod
    def restore_into(cls, rsrv: "ReplicatedServer", snaps: list) -> "ReplicatedServer":
        """Resume per-replica snapshots into a freshly constructed
        ``ReplicatedServer`` of the SAME shape (replica count, capacity).
        Router ownership is rebuilt from the restored servers' own
        rows/queues, so streaming/cancel keep working for the revived
        requests."""
        if len(snaps) != len(rsrv.servers):
            raise ValueError(
                f"{len(snaps)} replica snapshots for "
                f"{len(rsrv.servers)} replicas"
            )
        restored = [
            PipelineServer.restore(eng, snap)
            for eng, snap in zip(rsrv.engines, snaps)
        ]
        # swap the restored servers into the supervision tables; the fresh
        # (empty) servers they replace are closed so they stop voting on
        # the process health gauge
        old = rsrv.servers
        rsrv.servers = restored
        rsrv._by_group = {}
        rsrv._group_of = {}
        rsrv._failures = {}
        rsrv._seen_contained = {}
        for d, s in enumerate(restored):
            s._span_src = f"r{d}"
            s.stepline.name = f"r{d}"
            rsrv._by_group[d] = s
            rsrv._group_of[s] = d
            rsrv._failures[s] = collections.deque()
            rsrv._seen_contained[s] = s.containment_events
            rsrv._set_replica_gauge(d, s.health)
        if rsrv._gindex is not None:
            # the template servers' (empty) publications go; the restored
            # trees re-announce under the same group keys
            for d in rsrv._by_group:
                rsrv._gindex.drop_replica(f"g{d}")
        for d, s in enumerate(restored):
            rsrv._wire_index(s, d)
        for s in old:
            if getattr(s, "_radix", None) is not None:
                s._radix.publish = None  # no late entries under a live key
            try:
                s.close()
            except Exception:  # noqa: BLE001 — best-effort teardown
                logger.exception("restore_into: closing a template server")
        rsrv._owner = weakref.WeakKeyDictionary()
        for s in restored:
            for r in list(s._req) + list(s._queue):
                if r is not None:
                    rsrv._owner[r] = s
        return rsrv

    @property
    def counters(self):
        """Aggregated counters across live replicas."""
        from .server import Counters

        agg = Counters()
        for s in self.servers:
            for k, v in s.counters.snapshot().items():
                setattr(agg, k, getattr(agg, k) + v)
        return agg

    @property
    def health(self) -> str:
        """Router health = the WORST live replica state (a degraded replica
        degrades the endpoint; quarantined/closed replicas no longer vote).
        With no live replica at all the endpoint is DRAINING. Feeds the
        same ``/healthz`` provider slot as a single server's ``health``."""
        from .server import DRAINING

        if not self.servers:
            return DRAINING
        return max(
            (s.health for s in self.servers),
            key=_HEALTH_SEVERITY.__getitem__,
        )

    def close(self) -> None:
        """Shut every replica down (``PipelineServer.close``). Idempotent.
        EVERY replica is closed even when one raises — the per-replica
        errors are collected and re-raised as one aggregated error after
        the loop, so a single wedged replica can never block daemon
        shutdown."""
        with self._lock:
            errs = []
            for s in list(self.servers):
                d = self._group_of.get(s)
                try:
                    s.close()
                except Exception as e:  # noqa: BLE001 — keep closing
                    errs.append((d, e))
                    logger.exception("close: replica %s raised", d)
                else:
                    if d is not None:
                        self._set_replica_gauge(d, s.health)
            if self._router_trace is not None:
                self._router_trace.close()
            if errs:
                detail = "; ".join(f"replica {d}: {e!r}" for d, e in errs)
                raise RuntimeError(
                    f"close failed on {len(errs)} of "
                    f"{len(self.servers)} replica(s) — all others were "
                    f"closed: {detail}"
                ) from errs[0][1]

    def stats(self) -> dict:
        """Router-level view for ``/statz``: the aggregate counter snapshot
        plus per-replica counters, load (queued + in-flight), HEALTH and —
        on paged replicas — KV-block occupancy. ``offline_groups`` lists
        freed groups a ``spawn_replica()`` would reuse."""
        with self._lock:
            replicas = []
            for d in sorted(self._by_group):
                s = self._by_group[d]
                sl = s.stepline_stats()
                entry = {
                    "replica": d,
                    "health": s.health,
                    "counters": s.counters.snapshot(),
                    "queued": len(s._queue),
                    "in_flight": sum(
                        r is not None and not r.done for r in s._req
                    ),
                    "host_occupancy": sl["host_occupancy"],
                    "step_wall_p50_ms": sl["step_wall_p50_ms"],
                }
                if s.paged:
                    entry["kv_blocks_in_use"] = s._alloc.in_use
                    entry["kv_blocks_total"] = s._alloc.capacity_blocks
                    entry["kv_dtype"] = s.kv_dtype
                    entry["arena_bytes"] = s.arena_bytes()
                pc = s.prefix_cache_stats()
                if pc is not None:
                    # the trees are replica-local: the aggregate hides
                    # which replica is warm
                    entry["prefix_cache"] = pc
                replicas.append(entry)
            out = {
                "counters": self.counters.snapshot(),
                "replicas": replicas,
                "offline_groups": sorted(
                    d for d in range(len(self._groups))
                    if d not in self._by_group
                ),
            }
            if self._gindex is not None:
                out["global_index"] = self._gindex.stats()
            return out

    # ------------------------------------------------ step profiler fan-out

    def stepline_stats(self, last_n: int = 64) -> dict:
        """Per-replica step-profiler aggregates, keyed ``r<d>``."""
        with self._lock:
            return {
                f"r{d}": self._by_group[d].stepline_stats(last_n)
                for d in sorted(self._by_group)
            }

    def stepline_snapshot(self, last_n: Optional[int] = None) -> dict:
        """Per-replica step-ring tails, keyed ``r<d>``."""
        with self._lock:
            return {
                f"r{d}": self._by_group[d].stepline_snapshot(last_n)
                for d in sorted(self._by_group)
            }

    def stepline_capture(self, steps: int, wait_s: float = 5.0,
                         trace_dir: Optional[str] = None) -> dict:
        """Deep-capture fan-out: arm EVERY replica first (so the windows
        overlap in wall time), then wait out one shared deadline and
        return ``{"r<d>": bundle}``. ``trace_dir`` brackets the whole
        window with one process-wide ``torch.profiler`` trace (the
        profiler is per process), written there as a Chrome trace."""
        with self._lock:
            servers = [
                (d, self._by_group[d]) for d in sorted(self._by_group)
            ]
        prof = None
        if trace_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if any(s.engine.device.type == "cuda" for _, s in servers):
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        try:
            for _, s in servers:
                s.stepline.arm(steps)
            deadline = time.perf_counter() + wait_s
            out = {}
            for d, s in servers:
                s.stepline.wait_capture(
                    max(0.0, deadline - time.perf_counter())
                )
                out[f"r{d}"] = s.stepline.capture_bundle()
        finally:
            if prof is not None:
                prof.stop()
        if prof is not None:
            os.makedirs(trace_dir, exist_ok=True)
            path = os.path.join(
                trace_dir, f"stepline_{os.getpid()}_{time.time_ns()}.json"
            )
            prof.export_chrome_trace(path)
            out["device_trace"] = path
            out["device_trace_dir"] = trace_dir
        return out
