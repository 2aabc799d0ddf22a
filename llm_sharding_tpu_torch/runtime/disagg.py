"""Disaggregated prefill/decode serving: role-typed replica pools with
profiler-driven placement and cross-replica KV block streaming (the port
of ``llm_sharding_tpu/runtime/disagg.py``, context-parallel replicas
included: their streams read and land each block on its owner shard, and
a ``cp_shard_stream`` probe per shard guards the hand-off).

Prefill and decode have opposite hardware profiles — prefill is
compute-bound (one big batched matmul over the prompt), decode is
bandwidth-bound (one small matmul per token over a growing KV cache) — and
a unified replica interleaves them, so one long prefill stalls every live
stream's inter-token latency. DistServe (OSDI'24) and Splitwise (ISCA'24)
split the two phases onto separate machines; this module does the same
over ``ReplicatedServer``'s replicas, built ENTIRELY from transport
primitives the single server already has:

- **roles**: each replica group is ``prefill``, ``decode`` or ``unified``
  (``server_replica_role`` one-hot gauge). Fresh requests route to
  prefill-capable replicas; decode replicas only ever resume handed-off
  work, so their ITL never eats a stranger's prefill.
- **hand-off**: a prefill replica admits the request, computes its
  prompt's KV and samples the first token; the sweep then ``extract``s it
  (which INSERTS the prompt's block-aligned KV into the source's radix
  tree), streams those arena blocks host-side to the chosen decode replica
  (``_read_arena_blocks_dispatch`` → ``_write_arena_blocks``, the
  host-tier path — codes+scales when the arena is quantized), lands them
  in the decode replica's radix tree, and ``adopt``s the request there.
  The decode-side admission takes the radix hit: its prefix operand is
  GATHERED from the arena, so the decode replica performs ZERO prefill
  FLOPs for the streamed prefix and the continuation is token-identical
  to the unified run by the same argument as any radix hit. The stream +
  adopt run on a SIDECAR thread by default (``async_handoff``): the
  router's step thread only routes, fault-checks, extracts and QUEUES the
  block gathers (under the source's mutex, on the stream its programs run
  on, followed by a copy into pinned host memory and an event); the
  sidecar waits for that event, writes the blocks into the decode arena
  and adopts. ``close()`` rendezvouses with the sidecar before tearing
  replicas down. On one card the two replicas share one stream, so the
  host bytes are a detour: a device-to-device hand-off is left for later
  (``ROADMAP.md`` §B).
- **planner** (``runtime/placement.PlacementPlanner``): fitted
  prefill/decode latency models (a ``profile.json``) choose (a) the
  prefill:decode replica ratio for the offered mix, (b) the replica
  minimizing each request's predicted TTFT — folding in the radix-warmth
  signal — and (c) when to flip a replica's role through the drain/spawn
  elasticity path (``rebalance``). Without a planner the router falls
  back to the base health/warmth/load pick over role-eligible replicas.
- **cross-replica radix fills**: the same block-streaming path serves
  ordinary traffic — a radix miss on the routed replica that matches
  another replica's tree streams the matched blocks over host RAM instead
  of re-prefilling them.

Failure story: every hand-off step degrades, never corrupts. A transient
``kv_handoff`` fault (runtime/faults.py) defers the hand-off one sweep; a
permanent one leaves the request decoding where it lives (a prefill
replica CAN decode — the split is an optimization); a dead prefill or
decode replica is handled by the supervision layer, whose migration
targets are role-affine here but never role-restricted. Token identity
holds on every path because each fallback is an already-proven path
(adopt re-prefills what is not cached).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
import weakref
from typing import Optional

import numpy as np

from ..analysis.lockorder import named_lock
from ..obs.metrics import (
    CP_STREAM_SHARDS, DISAGG_HANDOFFS, DISAGG_TTFT_ERROR, HANDOFF_BYTES, REPLICA_ROLES,
    REPLICA_SPAWNS, set_replica_role,
)
from .blocks import BlockExhausted
from .faults import is_transient
from .replicated import ReplicatedServer
from .server import PipelineServer, Request, RequestFailed, ServerClosed

logger = logging.getLogger(__name__)

ROLE_PREFILL, ROLE_DECODE, ROLE_UNIFIED = REPLICA_ROLES


class DisaggServer(ReplicatedServer):
    """``ReplicatedServer`` with per-group serving roles, a prefill→decode
    KV hand-off engine and (optionally) a profiler-fitted placement
    planner. With every role ``unified`` it behaves exactly like its
    base class — disaggregation is a routing layer, not a fork.

    Role-typed pools need paged KV serving AND the automatic prefix cache
    (``kv_block_size``/``kv_blocks`` + ``prefix_cache != 'off'`` in the
    serve kwargs): the hand-off engine is the radix tree's block-streaming
    path, applied across replicas."""

    def __init__(
        self,
        cfg,
        params,
        *,
        data_parallel: int,
        roles: Optional[list] = None,
        prefill_replicas: Optional[int] = None,
        planner=None,  # runtime.placement.PlacementPlanner (optional)
        handoff_retries: int = 3,
        cross_fill: bool = True,
        async_handoff: bool = True,  # stream+adopt on a sidecar thread
        #   (False = the synchronous hand-off, for deterministic tests)
        **kw,
    ):
        if roles is not None and prefill_replicas is not None:
            raise ValueError(
                "roles and prefill_replicas are mutually exclusive — "
                "roles lists every group explicitly, prefill_replicas "
                "makes the first N prefill and the rest decode"
            )
        if prefill_replicas is not None:
            p = int(prefill_replicas)
            if not 1 <= p <= data_parallel - 1:
                raise ValueError(
                    f"prefill_replicas must be in [1, data_parallel-1] "
                    f"(both sides need at least one replica), got {p} "
                    f"with data_parallel={data_parallel}"
                )
            roles = [ROLE_PREFILL] * p + [ROLE_DECODE] * (data_parallel - p)
        if roles is None:
            roles = [ROLE_UNIFIED] * data_parallel
        roles = [str(r) for r in roles]
        if len(roles) != data_parallel:
            raise ValueError(
                f"{len(roles)} roles for data_parallel={data_parallel} "
                f"replica groups"
            )
        for r in roles:
            if r not in REPLICA_ROLES:
                raise ValueError(
                    f"unknown role {r!r}; expected one of {REPLICA_ROLES}"
                )
        if any(r != ROLE_UNIFIED for r in roles):
            if not any(r != ROLE_DECODE for r in roles):
                raise ValueError(
                    "no prefill-capable replica (every role is 'decode'); "
                    "at least one 'prefill' or 'unified' replica must "
                    "admit fresh requests"
                )
            if not any(r != ROLE_PREFILL for r in roles):
                raise ValueError(
                    "no decode-capable replica (every role is 'prefill'); "
                    "at least one 'decode' or 'unified' replica must "
                    "resume handed-off requests"
                )
            if kw.get("kv_block_size") is None:
                raise ValueError(
                    "disaggregated roles need paged KV serving (pass "
                    "kv_block_size/kv_blocks): the hand-off engine "
                    "streams arena blocks between replicas"
                )
            if kw.get("prefix_cache", "off") == "off":
                raise ValueError(
                    "disaggregated roles need prefix_cache='hbm' or "
                    "'host': the hand-off lands streamed KV in the decode "
                    "replica's radix tree so adoption resumes through the "
                    "arena-gathered prefix operand (zero re-prefill FLOPs)"
                )
        #: group index → role; assignment survives drain/spawn on the group
        self.roles: dict[int, str] = dict(enumerate(roles))
        self.planner = planner
        self.handoff_retries = int(handoff_retries)
        self.cross_fill = bool(cross_fill)
        # async hand-off sidecar: the device→host→device KV
        # stream + adopt run OFF the router's step thread, so a
        # long-prompt hand-off no longer stalls every live stream's
        # decode pump for its copy time (the serve_disagg_itl_* ITL p99
        # tail). The step thread still does the cheap irreversible part
        # (fault check, route, extract) so retry/fallback semantics are
        # unchanged; the sidecar adopts ONLY AFTER the stream landed (or
        # terminally failed — the cold adopt is the proven fallback).
        self.async_handoff = bool(async_handoff)
        self._handoff_jobs: "queue.Queue" = queue.Queue()
        self._handoff_thread: Optional[threading.Thread] = None
        self._handoff_inflight = 0
        self._handoff_cv = named_lock("disagg.handoff", "condition")
        self._handoff_stop = False  # close(): fail queued jobs typed
        # requests awaiting their prefill→decode hand-off (Request →
        # transient-fault attempt count); entries drop when the request
        # finishes, fails, hands off, or migrates off the prefill side
        self._pending_handoff: dict[Request, int] = {}
        # requests whose hand-off terminally fell back (permanent fault,
        # refused/unadoptable resume): they finish where they are — the
        # reconciliation sweep must not re-enqueue them every step
        self._no_handoff: "weakref.WeakSet[Request]" = weakref.WeakSet()
        # requests already counted under outcome="no_target" (the sweep
        # retries them every step until a decode replica returns — the
        # counter must record the episode once, not once per step)
        self._no_target_seen: "weakref.WeakSet[Request]" = weakref.WeakSet()
        # planner-routed requests awaiting their first token, for the
        # predicted-vs-observed TTFT error gauge (weak: a dropped request
        # must not linger)
        self._ttft_pred: "weakref.WeakKeyDictionary[Request, float]" = (
            weakref.WeakKeyDictionary()
        )
        # EWMA of the offered mix (prompt/new tokens per request) — what
        # rebalance() feeds the planner's ratio chooser
        self._mix_prompt: Optional[float] = None
        self._mix_new: Optional[float] = None
        super().__init__(cfg, params, data_parallel=data_parallel, **kw)

    # -------------------------------------------------------------- roles

    def _spawn_on_group(self, d: int) -> PipelineServer:
        srv = super()._spawn_on_group(d)
        set_replica_role(d, self.roles.get(d, ROLE_UNIFIED))
        return srv

    def _role_of(self, s: PipelineServer) -> str:
        d = self._group_of.get(s)
        return ROLE_UNIFIED if d is None else self.roles.get(d, ROLE_UNIFIED)

    def role_of(self, which) -> str:
        """Role of a replica by group index or server object."""
        if isinstance(which, PipelineServer):
            return self._role_of(which)
        return self.roles.get(int(which), ROLE_UNIFIED)

    def _disagg_active(self) -> bool:
        return any(r != ROLE_UNIFIED for r in self.roles.values())

    # ------------------------------------------------------------ routing

    def submit(self, prompt_ids, max_new_tokens: int = 128, **kw) -> Request:
        if kw.get("prefix") is not None or not self._disagg_active():
            # handle-bound requests carry their own per-replica shared KV
            # (covered-set routing); unified pools take the base pick
            return super().submit(prompt_ids, max_new_tokens, **kw)
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        with self._lock:
            s, pred = self._route_prefill(prompt)
            if self.cross_fill:
                streamed = self._maybe_cross_fill(s, prompt)
                if streamed and self.planner is not None:
                    # the fill just warmed the target — re-predict from
                    # its post-fill match so the error gauge stays honest
                    pred = self.planner.predict_ttft(
                        int(prompt.shape[0]),
                        cached_tokens=s.radix_match_tokens(prompt),
                        backlog_tokens=sum(
                            r.prompt_len for r in s._queue
                        ),
                        inflight_rows=sum(
                            r is not None and not r.done for r in s._req
                        ),
                    )
            req = s.submit(prompt, max_new_tokens, **kw)
            self._owner[req] = s
            self._note_mix(int(prompt.shape[0]), int(max_new_tokens))
            if self._role_of(s) == ROLE_PREFILL:
                self._pending_handoff[req] = 0
            if pred is not None:
                self._ttft_pred[req] = float(pred)
            return req

    def _route_prefill(self, prompt: np.ndarray):
        """The replica a fresh request prefills on: prefill-capable
        (prefill/unified) replicas only while any is live — a decode
        replica takes fresh traffic only as a last resort. With a planner,
        the pick minimizes PREDICTED TTFT from the fitted latency models
        (queued prefill backlog + this request's uncached tokens through
        the prefill fit, plus one marginal decode step per in-flight row);
        without one, the base health/warmth/load pick applies. Returns
        ``(server, predicted_ttft_or_None)``."""
        cands = [
            s for s in self.servers
            if not s._closed and self._role_of(s) != ROLE_DECODE
        ]
        if not cands:
            cands = [s for s in self.servers if not s._closed]
        if not cands:
            raise ServerClosed(
                "no live replica can accept this request (all "
                "quarantined/closed)"
            )
        if self.planner is None:
            return self._pick(covered=set(cands), prompt_ids=prompt), None
        from .server import _HEALTH_SEVERITY

        # health first, load second — the planner's argmin keeps the
        # EARLIEST index on ties, so the healthiest least-loaded replica
        # wins equal predictions
        cands.sort(key=lambda s: (_HEALTH_SEVERITY[s.health], self._load(s)))
        # cached-token inputs come from ONE cluster-index lookup when the
        # index is live (no per-candidate tree probe under its mutex);
        # the index is a hint — a stale depth only skews the TTFT
        # prediction, admission re-matches against the real tree
        if self._gindex is not None:
            keys = {s: f"g{self._group_of[s]}" for s in cands}
            scored = self._gindex.scores(prompt, keys.values())
            cached = {s: scored[keys[s]][0] for s in cands}
        else:
            cached = {s: s.radix_match_tokens(prompt) for s in cands}
        descr = [
            dict(
                cached_tokens=cached[s],
                backlog_tokens=sum(r.prompt_len for r in s._queue),
                inflight_rows=sum(
                    r is not None and not r.done for r in s._req
                ),
            )
            for s in cands
        ]
        i = self.planner.best_replica(int(prompt.shape[0]), descr)
        pred = self.planner.predict_ttft(int(prompt.shape[0]), **descr[i])
        return cands[i], pred

    def _route_decode(self, exclude=None) -> Optional[PipelineServer]:
        """The decode-capable replica a handed-off request resumes on:
        fewest in-flight rows first (in-flight rows ARE the decode load —
        every live row costs one marginal step per token), queue depth as
        the tie-break. None when no decode-capable replica is live."""
        cands = [
            s for s in self.servers
            if not s._closed and s is not exclude
            and self._role_of(s) != ROLE_PREFILL
        ]
        if not cands:
            return None
        return min(
            cands,
            key=lambda s: (
                sum(r is not None and not r.done for r in s._req),
                self._load(s),
            ),
        )

    def _migration_targets(self, st, rh) -> list:
        """Role-AFFINE migration ordering: a started request (generated
        tokens in its tail) prefers decode-capable survivors, a
        never-started one prefers prefill-capable — but the full candidate
        list survives, so failover correctness never depends on a role
        being live."""
        targets = super()._migration_targets(st, rh)
        if not self._disagg_active():
            return targets
        pref = (
            ROLE_DECODE if int(np.asarray(st.tail).size) > 0
            else ROLE_PREFILL
        )
        return sorted(
            targets,
            key=lambda t: (
                0 if self._role_of(t) in (pref, ROLE_UNIFIED) else 1,
                self._load(t),
            ),
        )

    def _note_mix(self, prompt_tokens: int, new_tokens: int) -> None:
        a = 0.2  # EWMA horizon ≈ the last ~10 requests
        if self._mix_prompt is None:
            self._mix_prompt = float(prompt_tokens)
            self._mix_new = float(new_tokens)
        else:
            self._mix_prompt += a * (prompt_tokens - self._mix_prompt)
            self._mix_new += a * (new_tokens - self._mix_new)

    # ----------------------------------------------------------- stepping

    def step(self) -> bool:
        progressed = super().step()
        if self._disagg_active():
            self._reconcile_handoffs()
            if self._pending_handoff:
                progressed |= self._sweep_handoffs()
        if self._ttft_pred:
            with self._lock:  # submits mutate _ttft_pred under the same lock
                self._observe_ttft()
        return progressed

    def _reconcile_handoffs(self) -> None:
        """Enqueue for hand-off any live row decoding on a PREFILL-role
        replica that the submit path never registered — requests landed
        there by supervision migration (a dead replica's work adopted by a
        prefill-capable survivor) or by a hand-off's adopt-fallback. The
        prefill tier must shed decode work however the work arrived;
        terminal fallbacks (``_no_handoff``) are exempt, so a request the
        decode side cannot hold is not churned every step."""
        with self._lock:
            for s in self.servers:
                if s._closed or self._role_of(s) != ROLE_PREFILL:
                    continue
                for r in s._req:
                    if (
                        r is not None and not r.done
                        and r not in self._pending_handoff
                        and r not in self._no_handoff
                        and r.embeds is None and r.prefix is None
                    ):
                        self._pending_handoff[r] = 0

    def _observe_ttft(self) -> None:
        """Feed ``server_disagg_ttft_error`` once per planner-routed
        request when its first token lands (the planner's accuracy signal
        — README documents how to read it)."""
        for req, pred in list(self._ttft_pred.items()):
            if req.first_token_at is None:
                if req.done:  # failed/cancelled before a token: no sample
                    self._ttft_pred.pop(req, None)
                continue
            obs = max(req.first_token_at - req.submitted_at, 1e-9)
            DISAGG_TTFT_ERROR.set(abs(pred - obs) / obs)
            self._ttft_pred.pop(req, None)

    # ----------------------------------------------------------- hand-off

    def _sweep_handoffs(self) -> bool:
        """Move every prefill-complete request to the decode side: a
        request on a prefill-role replica whose FIRST TOKEN has applied
        (prefill done, TTFT already served from the prefill side —
        DistServe's split point) is extracted, its prompt KV streamed, and
        adopted by a decode-capable replica."""
        did = False
        with self._lock:
            for req in list(self._pending_handoff):
                src = self._owner.get(req)
                if (
                    req.done or src is None or src._closed
                    or src not in self._group_of
                ):
                    self._pending_handoff.pop(req, None)
                    continue
                if self._role_of(src) != ROLE_PREFILL:
                    # supervision already migrated it off the prefill side
                    self._pending_handoff.pop(req, None)
                    continue
                if req.row is None or not req.tokens:
                    continue  # queued, or prefill/first token not applied
                if req.row in src._admitting:
                    continue  # mid-chunked-admission: extract would refuse
                attempts = self._pending_handoff.pop(req)
                did |= self._handoff(req, src, attempts)
        return did

    def _can_adopt(self, t: PipelineServer, resumed_len: int,
                   remaining: int) -> bool:
        """Cheap pre-check of ``adopt``'s budget validation: extraction is
        irreversible (the source row is released), so a hand-off must know
        the target can hold the RESUMED prompt before it pulls the request
        — a near-capacity request that no longer lays out anywhere keeps
        decoding where it is instead of dying."""
        try:
            bucket = t._bucket(resumed_len)
        except ValueError:
            return False
        chunked = t._chunked(bucket)
        total = bucket + remaining + (1 if chunked else 0)
        if total > t.capacity or total > t.cfg.max_position_embeddings:
            return False
        if t.paged:
            need = t._blocks_needed(bucket, remaining, 0, chunked)
            if need > t._alloc.capacity_blocks - t._handle_pins:
                return False
        return True

    def _handoff(self, req: Request, src: PipelineServer, attempts: int) -> bool:
        t0 = time.perf_counter()
        dst = self._route_decode(exclude=src)
        if dst is None:
            # no decode-capable survivor: keep decoding on the prefill
            # replica (it CAN — the split is an optimization, not a
            # capability boundary), retrying when a decode replica
            # spawns/revives
            if req not in self._no_target_seen:
                self._no_target_seen.add(req)
                DISAGG_HANDOFFS.labels(outcome="no_target").inc()
                self._decision("handoff", req=req, outcome="no_target")
            self._pending_handoff[req] = attempts
            return False
        self._no_target_seen.discard(req)
        fresh = len(req.tokens) - req.baked
        remaining = req.max_new - fresh
        if remaining < 1:
            return False  # at budget: it finishes this step anyway
        if not self._can_adopt(dst, req.prompt_len + fresh, remaining):
            self._no_handoff.add(req)
            DISAGG_HANDOFFS.labels(outcome="fallback").inc()
            self._decision(
                "handoff", req=req, outcome="fallback",
                reason="no_layout", attempts=attempts,
            )
            logger.warning(
                "request %d's resumed prompt (%d tokens, %d remaining) "
                "does not lay out on the decode side — decoding stays on "
                "replica %d",
                req.id, req.prompt_len + fresh, remaining,
                self._group_of[src],
            )
            return True
        if self._fault_plan is not None:
            try:
                self._fault_plan.check("kv_handoff", key=req.id)
            except Exception as e:  # noqa: BLE001 — classified below
                if is_transient(e) and attempts < self.handoff_retries:
                    self._pending_handoff[req] = attempts + 1
                    DISAGG_HANDOFFS.labels(outcome="retried").inc()
                    self._decision(
                        "handoff", req=req, outcome="retried",
                        attempts=attempts + 1,
                    )
                    logger.warning(
                        "transient kv_handoff fault for request %d "
                        "(attempt %d/%d): %r — retrying next sweep",
                        req.id, attempts + 1, self.handoff_retries, e,
                    )
                else:
                    self._no_handoff.add(req)
                    DISAGG_HANDOFFS.labels(outcome="fallback").inc()
                    self._decision(
                        "handoff", req=req, outcome="fallback",
                        reason="fault", attempts=attempts,
                    )
                    logger.warning(
                        "kv_handoff fault for request %d: %r — decoding "
                        "stays on replica %d",
                        req.id, e, self._group_of[src],
                    )
                return True
        if self._fault_plan is not None and src.cp > 1:
            # the per-shard probe of a context-parallel stream before the
            # extract (JAX ``disagg.py:524-560``): a shard that cannot serve
            # its slice defers (transient: retried) or falls back
            # (permanent) while the request still lives on its prefill
            # replica, classified as kv_handoff is
            try:
                for sh in range(src.cp):
                    self._fault_plan.check("cp_shard_stream", key=sh)
            except Exception as e:  # noqa: BLE001 — classified below
                CP_STREAM_SHARDS.labels(outcome="error").inc()
                if is_transient(e) and attempts < self.handoff_retries:
                    self._pending_handoff[req] = attempts + 1
                    DISAGG_HANDOFFS.labels(outcome="retried").inc()
                    self._decision(
                        "handoff", req=req, outcome="retried",
                        attempts=attempts + 1,
                    )
                    logger.warning(
                        "transient cp_shard_stream fault for request %d "
                        "(attempt %d/%d): %r — retrying next sweep",
                        req.id, attempts + 1, self.handoff_retries, e,
                    )
                else:
                    self._no_handoff.add(req)
                    DISAGG_HANDOFFS.labels(outcome="fallback").inc()
                    self._decision(
                        "handoff", req=req, outcome="fallback",
                        reason="fault", attempts=attempts,
                    )
                    logger.warning(
                        "cp_shard_stream fault for request %d: %r — "
                        "decoding stays on replica %d",
                        req.id, e, self._group_of[src],
                    )
                return True
        try:
            # with the async executor (inflight_steps>1) this extract
            # SETTLES the healthy prefill replica's in-flight dispatches
            # first (extract's settle=None default), so the hand-off
            # always leaves from a settled boundary: the streamed KV and
            # resumed prompt carry every token the device computed
            st = src.extract(req)
        except (ValueError, RuntimeError) as e:
            # raced a completion or a mid-admission state: retry next sweep
            if not req.done:
                self._pending_handoff[req] = attempts
            logger.info("hand-off of request %d deferred: %s", req.id, e)
            return False
        if self.async_handoff:
            # the expensive half — device→host→device stream + adopt —
            # moves to the sidecar; this step thread's pump continues
            # immediately. The request is already extracted (off src's
            # rows/queue), so neither the sweep nor the reconciliation
            # pass can double-enqueue it meanwhile.
            with self._handoff_cv:
                self._handoff_inflight += 1
            self._ensure_handoff_thread()
            self._handoff_jobs.put((req, src, dst, st, attempts, t0))
            return True
        return self._handoff_land(req, src, dst, st, attempts, t0)

    def _ensure_handoff_thread(self) -> None:
        if self._handoff_thread is None or not self._handoff_thread.is_alive():
            self._handoff_thread = threading.Thread(
                target=self._handoff_worker,
                name="disagg-handoff",
                daemon=True,
            )
            self._handoff_thread.start()

    def _handoff_worker(self) -> None:
        """Sidecar loop: land queued hand-offs one at a time (stream,
        then adopt). Every failure mode inside ``_handoff_land`` is
        already contained (cold adopt, fallback adopt, typed fail); the
        outer catch is a backstop so a bug can never strand a request in
        the extracted no-man's-land with consumers blocked forever."""
        while True:
            job = self._handoff_jobs.get()
            if job is None:
                return
            req, src = job[0], job[1]
            try:
                if self._handoff_stop:
                    # shutdown drained past the rendezvous timeout: do not
                    # land against replicas that are being torn down —
                    # fail the extracted request typed instead of letting
                    # the stream race the closing arenas
                    raise ServerClosed(
                        "router closed before the hand-off landed"
                    )
                self._handoff_land(*job)
            except Exception as e:  # noqa: BLE001 — backstop (see above)
                if not isinstance(e, ServerClosed):
                    logger.exception(
                        "async hand-off of request %d crashed", req.id
                    )
                try:
                    # under the router lock like every other failure path:
                    # _fail_request mutates rows/allocator/table mirrors
                    # that the step thread touches too
                    with self._lock:
                        src._fail_request(req, RequestFailed(
                            f"request {req.id} was lost in an async "
                            f"hand-off crash: {e!r}", req,
                        ))
                except Exception:  # noqa: BLE001
                    pass
            finally:
                with self._handoff_cv:
                    self._handoff_inflight -= 1
                    self._handoff_cv.notify_all()

    def _await_handoffs(self, timeout: float = 30.0) -> bool:
        """Completion rendezvous: block until every sidecar hand-off has
        landed (or ``timeout`` elapses). Called WITHOUT the router lock —
        the sidecar needs it to finish. True = drained."""
        with self._handoff_cv:
            return self._handoff_cv.wait_for(
                lambda: self._handoff_inflight == 0, timeout
            )

    def handoffs_pending(self) -> int:
        """Hand-offs not yet landed: swept-but-unstarted entries plus
        sidecar jobs in flight (what benches/tests should poll — the
        ``_pending_handoff`` dict alone misses the async window)."""
        with self._handoff_cv:
            return len(self._pending_handoff) + self._handoff_inflight

    def run_until_idle(self) -> None:
        """Base idling plus the async rendezvous: a request mid-sidecar
        is on NO replica (extracted, not yet adopted), so the base
        all-replicas-idle condition alone would return while its stream
        is still landing."""
        while True:
            super().run_until_idle()
            with self._handoff_cv:
                inflight = self._handoff_inflight
            if inflight:
                self._await_handoffs(timeout=0.1)
                continue
            # no sidecar work; a live swept-but-unstarted entry implies a
            # live row somewhere, which the base condition already covers
            if not any(not r.done for r in self._pending_handoff):
                return
            self.step()

    def close(self) -> None:
        # rendezvous BEFORE closing replicas: in-flight sidecar
        # hand-offs adopt (or terminally fall back) first, so a shutdown
        # cannot race a stream against a closing arena; then stop the
        # worker so the process exits cleanly. A rendezvous that TIMES
        # OUT (a hung device copy, a deep job backlog) must not tear the
        # replicas down under a still-running stream silently: flag the
        # worker to fail remaining jobs typed instead of landing them,
        # and say so loudly.
        if not self._await_handoffs():
            logger.warning(
                "close: async hand-offs still in flight after the "
                "rendezvous timeout — remaining jobs will fail typed "
                "(ServerClosed) instead of landing"
            )
        self._handoff_stop = True
        if self._handoff_thread is not None:
            self._handoff_jobs.put(None)
            self._handoff_thread.join(timeout=5.0)
            if self._handoff_thread.is_alive():
                logger.warning(
                    "close: hand-off sidecar did not exit within 5s "
                    "(a device copy may be hung); proceeding with "
                    "replica teardown"
                )
            self._handoff_thread = None
        super().close()

    def _handoff_land(
        self, req: Request, src: PipelineServer, dst: PipelineServer,
        st, attempts: int, t0: float,
    ) -> bool:
        """Land an extracted request on the decode side: stream the
        prompt's KV blocks (OUTSIDE the router lock — the copy is the
        stall the sidecar exists to absorb), then adopt under the lock.
        Identical semantics whether called inline (sync mode, under the
        sweep's reentrant lock) or from the sidecar. The span's ``queue_s``,
        ``stream_s`` and ``lock_s`` split its wall: waiting for the sidecar,
        the stream (the replicas' mutexes and the copy), the wait for the
        router lock."""
        t_land = time.perf_counter()
        streamed = nbytes = 0
        try:
            streamed, nbytes = self._stream_prefix(src, dst, st.prompt)
        except Exception:  # noqa: BLE001 — streaming is an optimization:
            # a failed transfer degrades to a cold (re-prefilling) adopt,
            # token-identical by the chunked-prefill argument
            logger.exception(
                "KV streaming for request %d failed; adopting cold", req.id
            )
        t_streamed = time.perf_counter()
        with self._lock:
            phases = dict(
                queue_s=round(t_land - t0, 6),
                stream_s=round(t_streamed - t_land, 6),
                lock_s=round(time.perf_counter() - t_streamed, 6),
            )
            return self._adopt_streamed(
                req, src, dst, st, attempts, t0, streamed, nbytes, phases
            )

    def _adopt_streamed(
        self, req: Request, src: PipelineServer, dst: PipelineServer,
        st, attempts: int, t0: float, streamed: int, nbytes: int,
        phases: Optional[dict] = None,
    ) -> bool:
        try:
            dst.adopt(st, req, front=True)
        except (ValueError, RuntimeError) as e:
            last = e
            for t in self._migration_targets(st, None):
                if t is dst:
                    continue
                try:
                    t.adopt(st, req, front=True)
                except (ValueError, RuntimeError) as e2:
                    last = e2
                    continue
                self._owner[req] = t
                self._no_handoff.add(req)
                DISAGG_HANDOFFS.labels(outcome="fallback").inc()
                self._decision(
                    "handoff", req=req, dur_s=time.perf_counter() - t0,
                    outcome="fallback", reason="refused_adopt",
                    dst=self._group_of.get(t), attempts=attempts,
                )
                logger.warning(
                    "hand-off target refused request %d; adopted by "
                    "replica %s instead", req.id, self._group_of.get(t),
                )
                return True
            src._fail_request(req, RequestFailed(
                f"request {req.id} could not be handed off or re-adopted "
                f"anywhere: {last!r}", req,
            ))
            DISAGG_HANDOFFS.labels(outcome="failed").inc()
            self._decision(
                "handoff", req=req, dur_s=time.perf_counter() - t0,
                outcome="failed", attempts=attempts,
            )
            return True
        self._owner[req] = dst
        # "ok" = the decode side resumes from cached KV (bytes streamed
        # now, or its tree already covered the prompt — e.g. repeated
        # prefixes); "cold" = it really re-prefills
        warm = streamed > 0 or dst.radix_match_tokens(
            np.asarray(st.prompt, np.int32)
        ) > 0
        DISAGG_HANDOFFS.labels(outcome="ok" if warm else "cold").inc()
        # .get(): the SOURCE may have been failed over/retired while the
        # sidecar was mid-stream — the adopt is still valid (the state is
        # host-side), the attribution just names a dead group
        frm, to = self._group_of.get(src), self._group_of.get(dst)
        self._decision(
            "handoff", req=req, dur_s=time.perf_counter() - t0,
            outcome="ok" if warm else "cold",
            frm=frm, dst=to,
            streamed=streamed, bytes=nbytes, attempts=attempts,
            **(phases or {}),
        )
        logger.info(
            "hand-off id=%d replica %s → %s (%d prefix tokens streamed, "
            "%d generated so far)",
            req.id, frm, to, streamed, len(req.tokens),
        )
        return True

    # ------------------------------------------------- KV block streaming

    def _stream_prefix(
        self, src: PipelineServer, dst: PipelineServer, prompt
    ) -> tuple:
        """Stream ``src``'s longest radix match for ``prompt`` into
        ``dst``'s tree through host RAM: device→host copy of the matched
        arena blocks on ``src`` (codes+scales when quantized), fresh block
        allocation + donating scatter on ``dst``, then a radix insert so
        the very next admission takes the hit. Returns ``(tokens, bytes)``
        landed ((0, 0) = nothing worth streaming / no room — the caller's
        adopt simply re-prefills, token-identically). Locks are taken one
        replica at a time (read side, then write side) — never nested."""
        ids = np.asarray(prompt, np.int32).reshape(-1)
        if src._radix is None or dst._radix is None:
            return 0, 0
        if (
            dst.kv_block_size != src.kv_block_size
            or dst.kv_dtype != src.kv_dtype
        ):
            return 0, 0  # heterogeneous pools cannot exchange raw blocks
        bs = src.kv_block_size
        with src._mutex:
            n = src._radix.match_tokens(ids)
            if n <= 0:
                return 0, 0
            ref = src._radix.take(ids, n)
            if ref is None:
                return 0, 0
            try:
                n = ref.n
                # dispatch-only under the mutex: the gathers and their
                # copy to pinned host memory are queued on the stream the
                # source's programs run on (behind the programs that wrote
                # the blocks — with inflight_steps > 1 the prompt's last
                # blocks may still be in flight — and ahead of any that
                # reuse them once released); the wait for the copy below
                # runs OUTSIDE the mutex, so the source's step pump is
                # never frozen for the copy time
                read = src._read_arena_blocks_dispatch(ref.blocks)
            finally:
                src._radix.release(ref)
        kv = read.numpy()
        del read
        with dst._mutex:
            have = dst._radix.match_tokens(ids[:n])
            if have >= n:
                return 0, 0  # destination already at least as warm
            nb_have, nb_all = have // bs, n // bs
            need = nb_all - nb_have
            cov: list[int] = []
            cref = None
            if nb_have:
                # pin the covered prefix so eviction cannot break the
                # path between here and the insert; its blocks fill the
                # insert call's covered slots (never consumed)
                cref = dst._radix.take(ids[:have], have)
                if cref is None or cref.n != have:
                    if cref is not None:
                        dst._radix.release(cref)
                    return 0, 0
                cov = list(cref.blocks)
            try:
                if not dst._radix.ensure_free(need):
                    return 0, 0
                try:
                    fresh = dst._alloc.alloc(need)
                except BlockExhausted:
                    return 0, 0
                tail = tuple(
                    np.ascontiguousarray(a[:, :, nb_have:nb_all])
                    for a in kv
                )
                try:
                    dst._write_arena_blocks(fresh, *tail)
                except Exception:
                    dst._alloc.free(fresh)
                    raise
                consumed = dst._radix.insert(ids[: nb_all * bs], cov + fresh)
                leftover = [b for b in fresh if b not in consumed]
                if leftover:
                    dst._alloc.free(leftover)
                landed = len(consumed)
                nbytes = 0
                if landed:
                    per_block = sum(
                        a.nbytes // max(a.shape[2], 1) for a in tail
                    )
                    nbytes = per_block * landed
                    HANDOFF_BYTES.inc(nbytes)
                return landed * bs, nbytes
            finally:
                if cref is not None:
                    dst._radix.release(cref)

    def _maybe_cross_fill(self, dst: PipelineServer, prompt: np.ndarray) -> int:
        """Cross-replica radix fill for ordinary traffic: when the routed
        replica's match is at least one block colder than the warmest
        other replica's, stream the difference instead of re-prefilling
        it. With the cluster index live, the warmest peer comes from ONE
        index lookup (deepest match, warmest tier) and only THAT peer's
        tree is probed to confirm — per-peer probing remains the fallback
        while the index is unbuilt. Best-effort — any failure (including
        a stale index entry) just means a cold prefill."""
        if dst._radix is None:
            return 0
        have = dst.radix_match_tokens(prompt)
        best, bn = None, have
        if self._gindex is not None:
            dst_key = f"g{self._group_of[dst]}"
            hit = self._gindex.best(prompt, exclude=(dst_key,))
            if hit is not None:
                src = self._by_group.get(int(hit[0][1:]))
                if src is not None and src is not dst and not src._closed:
                    # the peer's real tree governs what actually streams
                    m = src.radix_match_tokens(prompt)
                    if m > bn:
                        best, bn = src, m
        else:
            for s in self.servers:
                if s is dst or s._closed:
                    continue
                m = s.radix_match_tokens(prompt)
                if m > bn:
                    best, bn = s, m
        if best is None or bn - have < (dst.kv_block_size or 1):
            return 0
        try:
            tokens, _ = self._stream_prefix(best, dst, prompt[:bn])
            return tokens
        except Exception:  # noqa: BLE001 — a failed fill is a cold prefill
            logger.exception("cross-replica radix fill failed")
            return 0

    # --------------------------------------------------------- elasticity

    def spawn_replica(
        self, group: Optional[int] = None, role: Optional[str] = None
    ) -> PipelineServer:
        """Base ``spawn_replica`` plus role placement: ``group`` pins the
        freed group to revive (the rebalance flip respawns the
        group it just drained), ``role`` reassigns the group's role before
        the spawn. Defaults preserve the base behavior exactly (lowest
        freed group, role assignment unchanged)."""
        with self._lock:
            free = sorted(
                d for d in range(len(self._groups)) if d not in self._by_group
            )
            if not free:
                raise ValueError(
                    "no freed device group to spawn on (every group runs a "
                    "replica; drain one first)"
                )
            d = free[0] if group is None else int(group)
            if d not in free:
                raise ValueError(
                    f"device group {d} already runs a replica (free "
                    f"groups: {free})"
                )
            if role is not None:
                if role not in REPLICA_ROLES:
                    raise ValueError(
                        f"unknown role {role!r}; expected one of "
                        f"{REPLICA_ROLES}"
                    )
                self.roles[d] = role
            t0 = time.perf_counter()
            srv = self._spawn_on_group(d)
            REPLICA_SPAWNS.inc()
            self._decision(
                "spawn", dur_s=time.perf_counter() - t0, replica=d,
                role=self.roles.get(d, ROLE_UNIFIED),
            )
            logger.info(
                "replica spawned on group %d (role %s); %d replica(s) live",
                d, self.roles.get(d, ROLE_UNIFIED), len(self.servers),
            )
            return srv

    def rebalance(self) -> Optional[tuple]:
        """One planner-driven role flip toward the desired prefill:decode
        ratio for the OBSERVED workload mix (EWMA over submits): the
        least-loaded replica of the over-provisioned role drains (its live
        work migrates — zero dropped streams, the drain path) and respawns
        on the same group with the other role. One flip per call — churn
        is expensive, the caller paces. Returns ``(new_role, group)`` or
        ``None`` when the ratio already matches (or there is nothing safe
        to flip)."""
        if self.planner is None:
            raise ValueError(
                "rebalance needs a planner (PlacementPlanner from the "
                "profiler's fitted latency models / profile.json)"
            )
        with self._lock:
            live = sorted(self._by_group)
            if len(live) < 2 or self._mix_prompt is None:
                return None
            if any(self.roles.get(d) == ROLE_UNIFIED for d in live):
                return None  # unified pools have no ratio to converge
            want = self.planner.prefill_count(
                len(live), self._mix_prompt, self._mix_new
            )
            have = sum(
                1 for d in live if self.roles.get(d) == ROLE_PREFILL
            )
            if want == have:
                return None
            frm, to = (
                (ROLE_DECODE, ROLE_PREFILL) if want > have
                else (ROLE_PREFILL, ROLE_DECODE)
            )
            cands = [d for d in live if self.roles.get(d) == frm]
            if len(cands) < 2:
                return None  # never flip a role's last replica
            d = min(cands, key=lambda g: self._load(self._by_group[g]))
            self.drain(d)
            self.spawn_replica(group=d, role=to)
            self._decision(
                "rebalance", replica=d, frm=frm, to=to,
                want_prefill=want, live=len(live),
            )
            logger.info(
                "rebalance: replica %d flipped %s → %s (planner wants %d "
                "prefill of %d for mix ~%d prompt / ~%d new tokens)",
                d, frm, to, want, len(live), int(self._mix_prompt),
                int(self._mix_new),
            )
            return (to, d)

    # -------------------------------------------------------- load signals

    def role_load(self, extra: int = 0) -> float:
        """Role-aware autoscale signal: the WORST pool's normalized load.
        The prefill pool (prefill+unified replicas) is loaded by queued
        work plus ``extra`` (the ingress fair-queue backlog — fresh
        requests need prefill first); the decode pool (decode+unified) by
        in-flight rows. Taking the max means a saturated prefill tier
        reads as overload even while the decode tier idles — exactly the
        skew a global average hides. Falls back to the classic combined
        signal when every role is unified."""
        with self._lock:
            if not self._disagg_active():
                busy = extra
                slots = 0
                for s in self.servers:
                    if s._closed:
                        continue
                    busy += len(s._queue) + sum(
                        r is not None and not r.done for r in s._req
                    )
                    slots += len(s._req)
                if slots == 0:
                    return float("inf") if busy else 0.0
                return busy / slots
            p_busy, p_slots, d_busy, d_slots = extra, 0, 0, 0
            for s in self.servers:
                if s._closed:
                    continue
                role = self._role_of(s)
                inflight = sum(
                    r is not None and not r.done for r in s._req
                )
                if role != ROLE_DECODE:
                    # a prefill replica's in-flight rows ARE load (long
                    # chunked prefills, fallback requests decoding in
                    # place): queue-only counting read a saturated
                    # prefill tier with an empty queue as idle
                    p_busy += len(s._queue) + inflight
                    p_slots += len(s._req)
                if role != ROLE_PREFILL:
                    d_busy += inflight
                    d_slots += len(s._req)
            loads = []
            for busy, slots in ((p_busy, p_slots), (d_busy, d_slots)):
                if slots == 0:
                    loads.append(float("inf") if busy else 0.0)
                else:
                    loads.append(busy / slots)
            return max(loads)

    def prefill_queue_depth(self) -> int:
        """Queued work on the PREFILL-CAPABLE replicas — the ingress
        dispatch-depth signal (fresh dispatches land on the prefill side;
        counting the decode side's transient adoption queues would
        over-throttle the front door)."""
        with self._lock:
            if not self._disagg_active():
                return sum(len(s._queue) for s in self.servers)
            return sum(
                len(s._queue) for s in self.servers
                if not s._closed and self._role_of(s) != ROLE_DECODE
            )

    # ------------------------------------------------------------- stats

    def stats(self) -> dict:
        out = super().stats()
        for entry in out["replicas"]:
            entry["role"] = self.roles.get(entry["replica"], ROLE_UNIFIED)
        out["roles"] = {
            str(d): r for d, r in sorted(self.roles.items())
        }
        out["pending_handoffs"] = self.handoffs_pending()
        out["planner"] = self.planner is not None
        out["async_handoff"] = self.async_handoff
        return out
