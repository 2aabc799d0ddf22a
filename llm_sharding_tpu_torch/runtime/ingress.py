"""The HTTP/SSE front door of the serving stack: the port of
``llm_sharding_tpu/runtime/ingress.py``, whole.

- **OpenAI-style endpoints**: ``POST /v1/completions`` (the prompt as text,
  with a tokenizer, or as token ids; ``"stream": true`` streams tokens as
  server-sent events from the live decode loop) and ``POST
  /v1/embeddings`` (the prompt's ``[S, H]`` hidden states, the privacy
  entry ``PipelineServer.submit_embedding``). The response ``id`` carries
  the backend request id its ``request`` span logs; ``X-Trace-Id`` roots
  the trace and ``X-Deadline-Ms`` becomes the request's deadline.
- **Tenant fairness in front of admission**: a request resolves to a
  tenant (bearer key or ``X-Tenant``; 401 when none matches), passes the
  tenant's token-bucket rate limit and queued-work cap, and waits in a
  weighted fair queue (``runtime/fairness.py``) ordered by accumulated
  prefill and decode service. Overload is shed early and typed: 429 with
  ``Retry-After`` for a tenant's limits, 503 with ``Retry-After`` for the
  global cap or a drain, 504 for a deadline that expired in the queue.
- **Disconnects**: a client that leaves mid-stream (or stalls: the
  ``slow_client`` fault site) gets its backend row cancelled, which frees
  the row (and a paged server's KV blocks).
- **Failures**: a request the backend failed (containment, a CUDA error in
  a program) answers 500; so does one whose submit raised something other
  than a bad request, and every live request when the pump's step raises.
  Nothing is logged and carried on with a request left waiting.

One pump thread owns ``backend.step()`` (handlers never pump, so a stalled
client cannot stall decode), dispatches from the fair queue while the
backend queue has room (kept shallow: scheduling stays in the fair queue,
where tenant policy lives) and charges each tenant's service as tokens
commit. HTTP is the stdlib ``ThreadingHTTPServer``, as in ``obs/http.py``.
``attach_autoscaler`` keeps the JAX signature; the ``Autoscaler`` it takes
drives a ``ReplicatedServer`` and comes with the replicated slice.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np

from ..analysis.lockorder import named_lock
from ..obs.http import write_ignoring_disconnect
from ..obs.metrics import (
    INGRESS_ACTIVE, INGRESS_QUEUED, INGRESS_REQUESTS, INGRESS_TTFT,
)
from ..obs.trace import TraceContext, TraceWriter, emit_span
from .fairness import (
    FairQueue, GlobalQueueFull, RateLimited, TenantConfig, TenantQueueFull,
    UnknownTenant, load_tenants_config,
)
from .faults import InjectedFault
from .server import (
    DeadlineExceeded, QueueFull, ServerClosed, _M_REJECTED,
)

logger = logging.getLogger("llm_sharding_tpu_torch.ingress")

#: Retry-After the global sheds advertise (seconds): overload clears at
#: decode speed, not bucket-refill speed, so a flat small hint beats a
#: precise-looking lie.
OVERLOAD_RETRY_AFTER_S = 1.0


class _Pending:
    """One HTTP request's life through the ingress: queued (fair queue) →
    dispatched (backend ``Request`` attached) or shed (typed response).
    The handler thread blocks on ``event``; the pump thread sets it."""

    __slots__ = (
        "tenant", "prompt", "prompt_len", "max_new", "temperature", "seed",
        "top_k", "top_p", "stop", "stream", "arrived_at", "deadline_at",
        "event", "req", "shed", "charged", "rid", "interrupted", "embeds",
        "trace", "outcome", "failure",
    )

    def __init__(self, tenant, prompt, prompt_len, rid):
        self.tenant = tenant
        self.prompt = prompt
        self.prompt_len = prompt_len
        self.embeds = None  # [S, H] hidden states (the /v1/embeddings entry)
        self.rid = rid
        self.max_new = 16
        self.temperature = 0.0
        self.seed = 0
        self.top_k = None
        self.top_p = None
        self.stop = None
        self.stream = False
        self.arrived_at = time.monotonic()
        self.deadline_at: Optional[float] = None
        self.event = threading.Event()
        self.req = None
        self.shed: Optional[tuple] = None  # (code, outcome, retry_after, msg)
        self.charged = 0
        self.interrupted = False  # stop() cancelled the row mid-decode
        # the trace ROOT for this HTTP request (X-Trace-Id honored, else
        # generated); the backend Request's span becomes its child
        self.trace = TraceContext.new()
        self.outcome: Optional[str] = None
        # the pump's step raised while this entry was live: it answers 500
        self.failure: Optional[BaseException] = None


class IngressServer:
    """The HTTP front door over a ``PipelineServer`` or
    ``ReplicatedServer`` backend. Construct, ``start()``, submit traffic;
    ``begin_drain()`` for a graceful rolling restart (new requests 503,
    live streams finish); ``stop()`` tears everything down."""

    def __init__(
        self,
        backend,
        *,
        tenants=None,
        allow_anonymous: Optional[bool] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        tokenizer=None,
        max_queue: Optional[int] = None,
        dispatch_depth: Optional[int] = None,
        default_max_new: int = 128,
        model_name: str = "model",
        fault_plan=None,
        autoscaler=None,
        poll_interval_s: float = 0.001,
        autoscale_interval_s: float = 0.05,
        trace_path: Optional[str] = None,
    ):
        self.backend = backend
        # ingress-side spans (the per-trace ROOT + fair-queue wait) get
        # their own JSONL file — the backend files are per replica, and the
        # ingress runs on its own threads. trace-report merges them by
        # trace_id. Spans land in the flight recorder regardless.
        self._trace = (
            TraceWriter(f"{trace_path}.ingress") if trace_path else None
        )
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.default_max_new = int(default_max_new)
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = max_queue
        self._fault_plan = fault_plan
        self.autoscaler = autoscaler
        self._poll_s = float(poll_interval_s)
        self._autoscale_s = float(autoscale_interval_s)
        # tenant policy: a ready FairQueue, TenantConfig iterable, or the
        # --tenants-config JSON (path / text / dict); None = one unlimited
        # anonymous "default" tenant
        if isinstance(tenants, FairQueue):
            self.fair = tenants
        elif tenants is None:
            self.fair = FairQueue(
                allow_anonymous=True if allow_anonymous is None
                else allow_anonymous
            )
        elif isinstance(tenants, (str, dict)):
            cfgs, anon = load_tenants_config(tenants)
            self.fair = FairQueue(
                cfgs,
                allow_anonymous=anon if allow_anonymous is None
                else allow_anonymous,
            )
        else:
            cfgs = tuple(tenants)
            if not all(isinstance(c, TenantConfig) for c in cfgs):
                raise ValueError(
                    "tenants must be a FairQueue, TenantConfig iterable, "
                    "or a tenants-config JSON (path/text/dict)"
                )
            self.fair = FairQueue(
                cfgs,
                allow_anonymous=True if allow_anonymous is None
                else allow_anonymous,
            )
        # keep scheduling in the fair queue: the backend FIFO only ever
        # holds enough to keep admission busy
        replicas = len(getattr(backend, "servers", ()) or ()) or 1
        self.dispatch_depth = (
            int(dispatch_depth) if dispatch_depth is not None
            else max(2, 2 * replicas)
        )
        if self.dispatch_depth < 1:
            raise ValueError(
                f"dispatch_depth must be >= 1, got {self.dispatch_depth}"
            )
        self._mutex = named_lock("ingress.state")
        self._live: list[_Pending] = []
        # entries currently BETWEEN the fair queue and _live (popped, being
        # submitted): wait_idle counts them so the idle verdict can never
        # land inside a dispatch handoff
        self._dispatching = 0
        self._draining = False
        self._paused = False
        # held by the pump for each whole iteration; pause() acquires it
        # once so "paused" means "and the in-flight iteration has finished"
        self._pump_gate = named_lock("ingress.pump_gate")
        self._stop = False
        self._next_rid = 0
        self._httpd = ThreadingHTTPServer((host, port), self._handler_class())
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="ingress-http"
        )
        self._pump_thread = threading.Thread(
            target=self._pump_loop, daemon=True, name="ingress-pump"
        )
        # scale actions run OFF the pump thread: a spawn re-stages weights
        # for seconds, and the one thread that owns backend.step() must
        # keep decoding live streams through it
        self._autoscale_thread = threading.Thread(
            target=self._autoscale_loop, daemon=True, name="ingress-autoscale"
        )
        self._started = False

    # ------------------------------------------------------------ lifecycle

    def start(self) -> int:
        if not self._started:
            self._started = True
            self._http_thread.start()
            self._pump_thread.start()
            if self.autoscaler is not None:
                self._autoscale_thread.start()
        return self.port

    def attach_autoscaler(self, scaler) -> None:
        """Attach (or replace) the autoscaler. Safe after ``start()`` —
        the tick thread starts lazily here if the server is already
        running (the CLI builds the controller after the ingress so its
        load signal can fold in the fair-queue depth)."""
        self.autoscaler = scaler
        if (
            self._started and scaler is not None
            and not self._autoscale_thread.is_alive()
        ):
            self._autoscale_thread.start()

    def pause(self) -> None:
        """Suspend backend stepping and fair-queue dispatch (requests keep
        queueing). For operator maintenance windows — the CLI pauses the
        pump around a ``:placement`` rebuild so no dispatch can race the
        old server being drained, re-sharded and closed. BLOCKS until the
        pump's in-flight iteration has finished — a flag alone would
        return while a dispatch/step against the old server was still
        running."""
        self._paused = True
        with self._pump_gate:
            pass  # the current iteration (if any) has completed

    def resume(self) -> None:
        self._paused = False

    def begin_drain(self) -> None:
        """Graceful-shutdown entry (SIGTERM): flip to DRAINING — new
        requests answer 503 + ``Retry-After``, queued requests still
        dispatch and live streams finish. Idempotent."""
        self._draining = True
        logger.info("ingress draining: new requests now shed with 503")

    def wait_idle(self, timeout_s: float = 30.0) -> bool:
        """Block until no request is queued, mid-dispatch or streaming
        (the graceful SIGTERM path waits here before exiting 0). True
        when idle. Read order matters: queue depth FIRST, then the
        dispatch counter + live list under the mutex — an entry moving
        queue → dispatch → live is visible to at least one of the three
        reads at every instant."""
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout_s:
            queued = self.fair.depth()
            with self._mutex:
                busy = bool(self._live) or self._dispatching > 0
            if not busy and queued == 0:
                return True
            time.sleep(0.005)
        return False

    def stop(self) -> None:
        """Tear down: shed everything still queued (503), stop the pump
        and the HTTP listener. Live handler threads are daemons and die
        with their sockets."""
        if not self._started:
            self._httpd.server_close()
            return
        self._draining = True
        self._stop = True
        while True:
            popped = self.fair.pop()
            if popped is None:
                break
            _, e = popped
            self._shed(e, 503, "rejected_draining", OVERLOAD_RETRY_AFTER_S,
                       "server shutting down")
        # dispatched requests lose their front door with us: cancel their
        # rows so the backend frees slots + KV blocks instead of decoding
        # for clients nobody will ever answer
        with self._mutex:
            live = list(self._live)
        for e in live:
            # stamp BEFORE the cancel: the handler must report the
            # truncation (finish_reason "cancelled", outcome "failed"),
            # never a clean completion — cancel() alone marks the request
            # done with no error, indistinguishable from a genuine stop
            e.interrupted = True
            try:
                self.backend.cancel(e.req)
            except Exception:  # noqa: BLE001 — best-effort teardown
                logger.exception("stop: cancel of req %s failed", e.req.id)
        try:
            self._pump_thread.join(timeout=5.0)
        except RuntimeError:
            pass
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._trace is not None:
            self._trace.close()
        self._started = False

    @property
    def health(self) -> str:
        if self._draining:
            return "DRAINING"
        return str(getattr(self.backend, "health", "SERVING"))

    # ------------------------------------------------------------ pump loop

    def _backend_queued(self) -> int:
        # a disaggregated router counts only its PREFILL-capable replicas'
        # queues (fresh dispatches land there; the decode side's transient
        # adoption queues would over-throttle the front door)
        depth = getattr(self.backend, "prefill_queue_depth", None)
        if depth is not None:
            return int(depth())
        servers = getattr(self.backend, "servers", None)
        if servers is not None:
            return sum(len(s._queue) for s in servers)
        return len(self.backend._queue)

    def _pump_loop(self) -> None:
        # STEP-OWNERSHIP CONTRACT: this pump thread is the only caller of
        # backend.step() for the daemon's lifetime — the step profiler
        # (one thread records a step) and every per-step phase record key
        # off that. The async executor (inflight_steps>1) does NOT change
        # the contract: its scheduler/sidecar threads are internal to each
        # PipelineServer, never call step(), and synchronize with the pump
        # only through the server mutex — from here, an async step() is
        # simply a step that returns without blocking on the log fetch.
        while not self._stop:
            if self._paused:
                time.sleep(self._poll_s)
                continue
            did = False
            with self._pump_gate:  # pause() blocks on a full iteration
                try:
                    did |= self._dispatch_some()
                    did |= bool(self.backend.step())
                    did |= self._charge_and_reap()
                except Exception as err:  # noqa: BLE001 — the pump survives,
                    # the requests it was serving do not: each live one
                    # answers 500 and its row is cancelled
                    logger.exception("ingress pump iteration failed")
                    self._fail_live(err)
                    time.sleep(0.01)
            if not did:
                time.sleep(self._poll_s)

    def _fail_live(self, err: BaseException) -> None:
        """The backend's step raised past its own containment: every
        dispatched entry fails with ``err`` (a 500, or an SSE error event)
        and its row is cancelled, so no client waits on a request nobody
        steps any more."""
        with self._mutex:
            live = list(self._live)
        for e in live:
            if e.failure is None:
                e.failure = err
            try:
                self.backend.cancel(e.req)
            except Exception:  # noqa: BLE001 — best effort: the entry fails anyway
                logger.exception("cancel after a pump failure failed for req %s", e.req.id)

    def _autoscale_loop(self) -> None:
        while not self._stop:
            if not self._paused:
                try:
                    self.autoscaler.tick()
                except Exception:  # noqa: BLE001 — a policy error must
                    # never take the daemon's scaling thread down
                    logger.exception("autoscale tick failed")
            time.sleep(self._autoscale_s)

    def _shed(self, e: _Pending, code: int, outcome: str,
              retry_after: Optional[float], msg: str = "") -> None:
        e.shed = (code, outcome, retry_after, msg)
        e.event.set()

    def _dispatch_some(self) -> bool:
        did = False
        now = time.monotonic()
        # deadline-expired queued entries are shed NOW with a typed
        # answer; they never rot in queue to die of timeout downstream
        for _, e in self.fair.sweep(
            lambda e: e.deadline_at is not None and now >= e.deadline_at
        ):
            self._shed(e, 504, "deadline", None, "deadline expired in queue")
            did = True
        while self._backend_queued() < self.dispatch_depth:
            # _dispatching brackets the whole queue→_live handoff so
            # wait_idle can never observe "idle" with an entry in hand
            with self._mutex:
                self._dispatching += 1
            try:
                popped = self.fair.pop()
                if popped is None:
                    break
                tenant, e = popped
                if (
                    e.deadline_at is not None
                    and time.monotonic() >= e.deadline_at
                ):
                    self._shed(e, 504, "deadline", None,
                               "deadline expired in queue")
                    did = True
                    continue
                kw = dict(
                    temperature=e.temperature, seed=e.seed, tenant=tenant,
                    trace=e.trace,
                )
                if e.top_k is not None:
                    kw["top_k"] = e.top_k
                if e.top_p is not None:
                    kw["top_p"] = e.top_p
                if e.stop:
                    kw["stop"] = e.stop
                if e.deadline_at is not None:
                    kw["deadline_s"] = max(
                        e.deadline_at - time.monotonic(), 1e-3
                    )
                try:
                    if e.embeds is not None:
                        # privacy entry over HTTP: the request enters as
                        # hidden states — token ids never reach this process
                        req = self.backend.submit_embedding(
                            e.embeds, e.max_new, **kw
                        )
                    else:
                        req = self.backend.submit(e.prompt, e.max_new, **kw)
                except QueueFull:
                    # backend backpressure: put the entry back at its
                    # tenant's head, retry next pass — never drop covertly
                    self.fair.push_front(tenant, e)
                    break
                except ServerClosed:
                    self._shed(e, 503, "rejected_draining",
                               OVERLOAD_RETRY_AFTER_S, "backend closed")
                    did = True
                    continue
                except (ValueError, NotImplementedError) as err:
                    self._shed(e, 400, "bad_request", None, str(err))
                    did = True
                    continue
                except Exception as err:  # noqa: BLE001 — the backend failed
                    # taking the request (a device error): a 500, never a
                    # handler left waiting
                    logger.exception("backend submit failed for tenant %s", tenant)
                    self._shed(e, 500, "failed", None, f"backend submit failed: {err!r}")
                    did = True
                    continue
                # prefill service is known at dispatch; decode accrues in
                # _charge_and_reap
                self.fair.charge(tenant, e.prompt_len, kind="prefill")
                # the fair-queue wait, attributed: arrival → backend submit
                emit_span(
                    self._trace, "queue",
                    dur_s=time.monotonic() - e.arrived_at,
                    parent_of=e.trace, src="ingress",
                    tenant=tenant, rid=e.rid,
                )
                e.req = req
                with self._mutex:
                    self._live.append(e)
                INGRESS_ACTIVE.set(len(self._live))
                e.event.set()
                did = True
            finally:
                with self._mutex:
                    self._dispatching -= 1
        INGRESS_QUEUED.set(self.fair.depth())
        return did

    def _charge_and_reap(self) -> bool:
        """Accrue decode service for every dispatched entry. Entries leave
        ``_live`` ONLY when their handler finishes (its ``finally``) — the
        handler owns the final client write, and ``wait_idle``/``stop``
        must not observe "idle" while a response tail is still going out
        (a SIGTERM drain that exits then would truncate the stream)."""
        did = False
        with self._mutex:
            live = list(self._live)
        for e in live:
            n = len(e.req.tokens)
            if n > e.charged:
                self.fair.charge(e.tenant, n - e.charged, kind="decode")
                e.charged = n
                did = True
        return did

    def _lock_for(self, req):
        """The mutex guarding ``req.tokens`` snapshots — re-resolved per
        read because a dp migration moves the request between replicas."""
        owner_map = getattr(self.backend, "_owner", None)
        if owner_map is not None:
            s = owner_map.get(req)
            return s._mutex if s is not None else None
        return self.backend._mutex

    def _read(self, req, idx: int) -> tuple:
        lock = self._lock_for(req)
        if lock is None:
            return list(req.tokens[idx:]), req.done, req.error
        with lock:  # shardlint: lock server.mutex
            return list(req.tokens[idx:]), req.done, req.error

    # ------------------------------------------------------------ handler

    def _count(self, tenant: Optional[str], outcome: str) -> None:
        INGRESS_REQUESTS.labels(
            tenant=tenant or "unknown", outcome=outcome
        ).inc()

    def _count_entry(self, e: _Pending, outcome: str) -> None:
        """Outcome accounting for a DISPATCHED entry: the counter plus the
        outcome the ingress root span reports at the end of the request."""
        e.outcome = outcome
        self._count(e.tenant, outcome)

    def _finish_trace(self, e: _Pending, outcome: str) -> None:
        """Close the trace tree's ROOT: the ingress span covering the whole
        HTTP request (arrival → last byte), with its outcome. Every other
        span of the trace — fair-queue wait, backend request and its
        children, hand-off — parents up to this one."""
        fields: dict = {"tenant": e.tenant, "rid": e.rid, "outcome": outcome}
        if e.req is not None:
            fields["id"] = e.req.id
            fields["tokens"] = len(e.req.tokens)
        emit_span(
            self._trace, "ingress",
            dur_s=time.monotonic() - e.arrived_at,
            trace=e.trace, src="ingress", **fields,
        )

    def _reject(self, reason: str) -> None:
        # the same counter family the backend's admission control feeds —
        # one place to alert on every early shed, wherever it happened
        _M_REJECTED.labels(reason=reason).inc()

    def _decode_delta(self, acc: list, prev: str) -> tuple:
        """Incremental detokenization (same discipline as the CLI daemon:
        hold back while the decoder shows a partial codepoint)."""
        if self.tokenizer is None:
            return "", prev
        text = self.tokenizer.decode(acc, skip_special_tokens=True)
        if len(text) > len(prev) and not text.endswith("�"):
            return text[len(prev):], text
        return "", prev

    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # one logger, not stderr spam
                pass

            # -- plumbing ----------------------------------------------

            def _json(self, code: int, obj: dict, extra_headers=()) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in extra_headers:
                    self.send_header(k, v)
                self.end_headers()
                self._write(body)

            def _error(
                self, code: int, etype: str, msg: str,
                retry_after: Optional[float] = None,
                trace_id: Optional[str] = None,
            ) -> None:
                headers = []
                if trace_id is not None:
                    # rejections echo the trace id too — an upstream that
                    # propagated X-Trace-Id can tie its 429/503/504 back
                    # to the (single-span) trace this side recorded
                    headers.append(("X-Trace-Id", trace_id))
                if retry_after is not None:
                    # ceil to a whole second: Retry-After is integer
                    # seconds per RFC 9110, and "0" would invite an
                    # immediate identical retry
                    headers.append(
                        ("Retry-After", str(max(1, int(retry_after + 0.999))))
                    )
                self._json(
                    code,
                    {"error": {"type": etype, "message": msg, "code": code}},
                    headers,
                )

            def _write(self, data: bytes) -> bool:
                """True when the client is still there. Disconnects are a
                NORMAL event at the front door — never a handler-thread
                traceback. One shared disconnect policy with the metrics
                exposition (obs/http.py)."""
                return write_ignoring_disconnect(
                    self.wfile, data, flush=True
                )

            # -- routes ------------------------------------------------

            def do_GET(self):  # noqa: N802 — http.server API
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                if path == "/healthz":
                    state = server.health
                    if state == "SERVING":
                        self._json(200, {"status": "ok"})
                    else:
                        self._json(503, {"status": state})
                elif path == "/v1/models":
                    self._json(200, {
                        "object": "list",
                        "data": [{
                            "id": server.model_name, "object": "model",
                        }],
                    })
                elif path == "/indexz":
                    # the cluster-global radix index's routing view (how
                    # much of the fleet's trees it mirrors); 404 when the
                    # backend has no index (single replica / cache off /
                    # global_index=False)
                    gx = getattr(server.backend, "_gindex", None)
                    if gx is None:
                        self._error(
                            404, "no_index",
                            "backend has no cluster-global radix index",
                        )
                    else:
                        self._json(200, gx.stats())
                else:
                    self._error(404, "not_found", "try POST /v1/completions")

            def do_POST(self):  # noqa: N802 — http.server API
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                if path == "/v1/completions":
                    server._handle_completion(self)
                elif path == "/v1/embeddings":
                    # the privacy entry (PipelineServer.submit_embedding)
                    # as an endpoint: 'input' carries [S, H] prompt hidden
                    # states, the response is an ordinary completion
                    server._handle_completion(self, embeddings=True)
                else:
                    self._error(
                        404, "not_found",
                        "try POST /v1/completions or /v1/embeddings",
                    )

        return Handler

    # --------------------------------------------------- completion route

    def _resolve_tenant(self, handler) -> str:
        auth = handler.headers.get("Authorization", "")
        bearer = auth[7:].strip() if auth.startswith("Bearer ") else None
        header = handler.headers.get("X-Tenant")
        return self.fair.resolve(bearer=bearer, header=header)

    def _parse_body(self, handler) -> dict:
        length = int(handler.headers.get("Content-Length", 0) or 0)
        raw = handler.rfile.read(length) if length else b""
        obj = json.loads(raw.decode("utf-8"))
        if not isinstance(obj, dict):
            raise ValueError("request body must be a JSON object")
        return obj

    def _build_entry(self, tenant: str, body: dict, handler) -> _Pending:
        prompt = body.get("prompt")
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError(
                    "this deployment has no tokenizer: send 'prompt' as a "
                    "list of token ids"
                )
            ids = np.asarray(
                self.tokenizer(prompt)["input_ids"], np.int32
            ).reshape(-1)
        elif isinstance(prompt, (list, tuple)):
            ids = np.asarray([int(t) for t in prompt], np.int32)
        else:
            raise ValueError("'prompt' must be a string or a token-id list")
        if ids.size < 1:
            raise ValueError("'prompt' must be non-empty")
        with self._mutex:
            rid = self._next_rid
            self._next_rid += 1
        e = _Pending(tenant, ids, int(ids.size), rid)
        self._apply_knobs(e, body, handler)
        return e

    def _build_embeddings_entry(
        self, tenant: str, body: dict, handler
    ) -> _Pending:
        """The ``/v1/embeddings`` body: ``input`` is one prompt's hidden
        states, ``[S, H]`` floats (``Engine.embed_prompt`` output: raw text
        and ids never leave the node that embedded them). Sampling/stream/deadline knobs are shared
        with completions; the fair queue charges prefill by ``S``."""
        arr = body.get("input")
        if arr is None:
            raise ValueError(
                "'input' must carry [seq, hidden] prompt embeddings"
            )
        h = np.asarray(arr, np.float32)
        if h.ndim == 3 and h.shape[0] == 1:
            h = h[0]
        if h.ndim != 2 or h.shape[0] < 1:
            raise ValueError(
                f"'input' must be a [seq, hidden] float matrix, got shape "
                f"{h.shape}"
            )
        with self._mutex:
            rid = self._next_rid
            self._next_rid += 1
        e = _Pending(tenant, None, int(h.shape[0]), rid)
        e.embeds = h
        self._apply_knobs(e, body, handler)
        return e

    def _apply_knobs(self, e: _Pending, body: dict, handler) -> None:
        """Sampling/stream/deadline knobs shared by BOTH entry parsers —
        one definition, so a knob added to completions cannot silently
        skip the embeddings endpoint."""
        e.max_new = int(body.get("max_tokens", self.default_max_new))
        if e.max_new < 1:
            raise ValueError("'max_tokens' must be >= 1")
        e.temperature = float(body.get("temperature", 0.0))
        e.seed = int(body.get("seed", 0))
        if "top_k" in body:
            e.top_k = int(body["top_k"])
        if "top_p" in body:
            e.top_p = float(body["top_p"])
        stop = body.get("stop")
        if stop is not None:
            e.stop = (stop,) if isinstance(stop, str) else tuple(stop)
        e.stream = bool(body.get("stream", False))
        tid = handler.headers.get("X-Trace-Id")
        if tid is not None:
            # caller-supplied trace id (Dapper-style propagation from an
            # upstream service); malformed values fall back to generated
            e.trace = TraceContext.new(trace_id=tid)
        dl_ms = handler.headers.get("X-Deadline-Ms")
        if dl_ms is not None:
            dl_ms = float(dl_ms)
            if dl_ms <= 0:
                raise ValueError("X-Deadline-Ms must be > 0")
            e.deadline_at = e.arrived_at + dl_ms / 1000.0

    def _handle_completion(self, handler, embeddings: bool = False) -> None:
        # -- tenant resolution + typed early shedding ----------------------
        try:
            tenant = self._resolve_tenant(handler)
        except UnknownTenant as err:
            self._count(None, "unauthorized")
            handler._error(401, "unauthorized", str(err))
            return
        if self._fault_plan is not None:
            try:
                self._fault_plan.check("http_request", key=tenant)
            except InjectedFault as err:
                # infrastructure fault at the front door: shed, typed,
                # retryable — the handler thread survives
                self._count(tenant, "fault")
                self._reject("ingress_fault")
                handler._error(
                    503, "ingress_fault", str(err), OVERLOAD_RETRY_AFTER_S
                )
                return
        if self._draining or self._stop:
            self._count(tenant, "rejected_draining")
            self._reject("draining")
            handler._error(
                503, "draining", "server is draining; retry elsewhere",
                OVERLOAD_RETRY_AFTER_S,
            )
            return
        try:
            body = self._parse_body(handler)
            e = (
                self._build_embeddings_entry(tenant, body, handler)
                if embeddings else self._build_entry(tenant, body, handler)
            )
        except (ValueError, TypeError, json.JSONDecodeError) as err:
            self._count(tenant, "bad_request")
            handler._error(400, "bad_request", str(err))
            return
        try:
            # atomic: cap checks + bucket draw + enqueue under one lock —
            # N simultaneous arrivals cannot overshoot any cap, and a
            # request the queue refuses never costs a rate token
            self.fair.admit_and_push(tenant, e, total_cap=self.max_queue)
        except RateLimited as err:
            self._count(tenant, "rejected_rate")
            self._reject("rate_limit")
            handler._error(
                429, "rate_limited", str(err), err.retry_after_s,
                trace_id=e.trace.trace_id,
            )
            self._finish_trace(e, "rejected_rate")
            return
        except TenantQueueFull as err:
            self._count(tenant, "rejected_tenant_queue")
            self._reject("tenant_queue_full")
            handler._error(
                429, "tenant_queue_full", str(err), err.retry_after_s,
                trace_id=e.trace.trace_id,
            )
            self._finish_trace(e, "rejected_tenant_queue")
            return
        except GlobalQueueFull as err:
            self._count(tenant, "rejected_overload")
            self._reject("ingress_queue_full")
            handler._error(
                503, "overloaded", str(err), OVERLOAD_RETRY_AFTER_S,
                trace_id=e.trace.trace_id,
            )
            self._finish_trace(e, "rejected_overload")
            return
        INGRESS_QUEUED.set(self.fair.depth())

        # -- wait for the pump to dispatch or shed -------------------------
        while not e.event.wait(0.05):
            if self._stop:
                if self.fair.remove(tenant, e):
                    self._count(tenant, "rejected_draining")
                    self._reject("draining")
                    handler._error(
                        503, "draining", "server shutting down",
                        OVERLOAD_RETRY_AFTER_S, trace_id=e.trace.trace_id,
                    )
                    self._finish_trace(e, "rejected_draining")
                    return
        if e.shed is not None:
            code, outcome, retry_after, msg = e.shed
            self._count(tenant, outcome)
            # every queued-then-shed outcome lands in server_rejected_total
            # too — one family to alert on, wherever the shed happened
            if outcome == "deadline":
                self._reject("deadline")
            elif outcome == "rejected_draining":
                self._reject("draining")
            handler._error(
                code, outcome, msg or outcome, retry_after,
                trace_id=e.trace.trace_id,
            )
            self._finish_trace(e, outcome)
            return

        # -- dispatched: stream or collect ---------------------------------
        try:
            if e.stream:
                self._respond_stream(handler, e)
            else:
                self._respond_whole(handler, e)
        finally:
            with self._mutex:
                try:
                    self._live.remove(e)
                except ValueError:
                    pass
                INGRESS_ACTIVE.set(len(self._live))
            self._finish_trace(e, e.outcome or "unknown")

    # ------------------------------------------------------------ responses

    def _finish_reason(self, e: _Pending) -> str:
        if e.interrupted:
            # stop() cancelled the row: the output is TRUNCATED — it must
            # never read as a natural early stop
            return "cancelled"
        return "length" if len(e.req.tokens) >= e.max_new else "stop"

    def _final_outcome(self, e: _Pending) -> str:
        return "failed" if e.interrupted else "ok"

    def _usage(self, e: _Pending) -> dict:
        c = len(e.req.tokens)
        return {
            "prompt_tokens": e.prompt_len,
            "completion_tokens": c,
            "total_tokens": e.prompt_len + c,
        }

    def _classify_failure(self, err: BaseException) -> tuple:
        """(HTTP code, outcome label, retry_after) for a request that was
        ACCEPTED and then failed in the backend."""
        cause = getattr(err, "__cause__", None) or err
        seen = set()
        while cause is not None and id(cause) not in seen:
            seen.add(id(cause))
            if isinstance(cause, DeadlineExceeded):
                return 504, "deadline", None
            if isinstance(cause, ServerClosed):
                return 503, "rejected_draining", OVERLOAD_RETRY_AFTER_S
            cause = getattr(cause, "__cause__", None)
        return 500, "failed", None

    def _respond_whole(self, handler, e: _Pending) -> None:
        req = e.req
        idx = 0
        acc: list = []
        first = True
        while True:
            batch, done, error = self._read(req, idx)
            if e.failure is not None:
                done, error = True, e.failure
            acc.extend(batch)
            idx += len(batch)
            if batch and first:
                INGRESS_TTFT.labels(tenant=e.tenant).observe(
                    time.monotonic() - e.arrived_at,
                    trace_id=e.trace.trace_id,
                )
                first = False
            if done:
                break
            time.sleep(self._poll_s)
        if error is not None:
            code, outcome, retry_after = self._classify_failure(error)
            self._count_entry(e, outcome)
            if outcome == "deadline":
                self._reject("deadline")
            handler._error(
                code, outcome, str(error), retry_after,
                trace_id=e.trace.trace_id,
            )
            return
        text = ""
        if self.tokenizer is not None:
            text = self.tokenizer.decode(acc, skip_special_tokens=True)
        handler._json(200, {
            "id": f"cmpl-{req.id}",
            "object": "text_completion",
            "created": int(time.time()),
            "model": self.model_name,
            "choices": [{
                "index": 0,
                "text": text,
                "token_ids": [int(t) for t in acc],
                "finish_reason": self._finish_reason(e),
            }],
            "usage": self._usage(e),
        }, [
            ("X-Request-Id", f"cmpl-{req.id}"),
            ("X-Trace-Id", e.trace.trace_id),
        ])
        self._count_entry(e, self._final_outcome(e))

    def _sse_write(self, handler, e: _Pending, obj: dict) -> bool:
        """One SSE event. An injected ``slow_client`` fault is a simulated
        disconnect and takes the same path as a real one: False."""
        if self._fault_plan is not None:
            try:
                self._fault_plan.check("slow_client", key=e.tenant)
            except InjectedFault:
                return False
        data = b"data: " + json.dumps(obj).encode() + b"\n\n"
        return handler._write(data)

    def _respond_stream(self, handler, e: _Pending) -> None:
        req = e.req
        handler.send_response(200)
        handler.send_header("Content-Type", "text/event-stream")
        handler.send_header("Cache-Control", "no-cache")
        handler.send_header("Connection", "close")
        handler.send_header("X-Request-Id", f"cmpl-{req.id}")
        handler.send_header("X-Trace-Id", e.trace.trace_id)
        handler.end_headers()
        base = {
            "id": f"cmpl-{req.id}",
            "object": "text_completion",
            "model": self.model_name,
        }
        idx = 0
        acc: list = []
        prev = ""
        first = True
        while True:
            batch, done, error = self._read(req, idx)
            if e.failure is not None:
                done, error = True, e.failure
            if batch:
                if first:
                    INGRESS_TTFT.labels(tenant=e.tenant).observe(
                        time.monotonic() - e.arrived_at,
                        trace_id=e.trace.trace_id,
                    )
                    first = False
                acc.extend(batch)
                idx += len(batch)
                delta, prev = self._decode_delta(acc, prev)
                ev = dict(base)
                ev["choices"] = [{
                    "index": 0,
                    "text": delta,
                    "token_ids": [int(t) for t in batch],
                    "finish_reason": None,
                }]
                if not self._sse_write(handler, e, ev):
                    self._disconnect(e)
                    return
            if done:
                break
            if error is not None:
                break
            time.sleep(self._poll_s)
        if error is not None:
            code, outcome, _ = self._classify_failure(error)
            del code  # the SSE status line already went out as 200
            self._count_entry(e, outcome)
            if outcome == "deadline":
                self._reject("deadline")
            ev = dict(base)
            ev["choices"] = [{
                "index": 0, "text": "", "token_ids": [],
                "finish_reason": outcome,
            }]
            ev["error"] = {"type": outcome, "message": str(error)}
            self._sse_write(handler, e, ev)
            handler._write(b"data: [DONE]\n\n")
            return
        ev = dict(base)
        ev["choices"] = [{
            "index": 0, "text": "", "token_ids": [],
            "finish_reason": self._finish_reason(e),
        }]
        ev["usage"] = self._usage(e)
        if not self._sse_write(handler, e, ev):
            self._disconnect(e)
            return
        handler._write(b"data: [DONE]\n\n")
        self._count_entry(e, self._final_outcome(e))

    def _disconnect(self, e: _Pending) -> None:
        """The client went away mid-stream: cancel the backend row so its
        slot AND its KV blocks free immediately — an abandoned stream
        must never hold arena blocks to completion."""
        self._count_entry(e, "disconnect")
        try:
            self.backend.cancel(e.req)
        except Exception:  # noqa: BLE001 — cancel is best-effort here; the
            # row finishes on its own if the dispatch failed
            logger.exception("disconnect cancel failed for req %s", e.req.id)
        logger.info(
            "client disconnect: tenant=%s req=%d after %d token(s) — row "
            "cancelled, blocks freed", e.tenant, e.req.id, len(e.req.tokens),
        )


def start_ingress(
    backend,
    *,
    port: int,
    tokenizer=None,
    tenants=None,
    autoscaler=None,
    fault_plan=None,
    on_error: Callable[[str], None] = lambda msg: None,
    **kw,
) -> Optional[IngressServer]:
    """CLI helper mirroring ``_start_metrics``: bind failures are reported
    and non-fatal (the daemon still serves stdin + the Python API)."""
    try:
        ing = IngressServer(
            backend, port=port, tokenizer=tokenizer, tenants=tenants,
            autoscaler=autoscaler, fault_plan=fault_plan, **kw,
        )
        ing.start()
    except OSError as err:
        on_error(f"ingress endpoint disabled: {err}")
        return None
    return ing
