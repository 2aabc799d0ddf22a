"""Metrics exposition over HTTP: a stdlib background thread, no deps. The
port's own copy of ``llm_sharding_tpu/obs/http.py`` (``MetricsServer`` and
``write_ignoring_disconnect``), serving the port's registry.

``MetricsServer`` serves the process-wide registry on:

- ``/metrics`` — Prometheus text format 0.0.4 (scrape target); a scraper
  negotiating ``Accept: application/openmetrics-text`` gets the
  OpenMetrics flavor with slow-request trace-id exemplars on the latency
  histograms (exemplars are not legal 0.0.4 syntax, so the default stays
  strictly-parseable plain text);
- ``/statz``   — JSON: the registry snapshot (histograms with p50/p90/p99)
  plus any extra named providers (e.g. a server's ``counters.snapshot``);
- ``/debugz``  — the flight-recorder postmortem bundle: recent spans from
  the process-wide in-memory ring (``obs.trace.FLIGHT_RECORDER``, present
  even when no ``trace_path`` was configured), the step-profiler ring
  tails of every live server (``obs.stepline.debug_snapshot``: what the
  serve loop was DOING per step), the metrics snapshot (with slow-request
  exemplars), every ``/statz`` provider and the health state, as one JSON
  object;
- ``/profilez`` — the step profiler's on-demand window: a bare GET returns
  ring-tail stats + records; ``?steps=N[&wait_s=S]`` arms an N-step deep
  capture on the attached provider (``PipelineServer.stepline_capture``)
  and returns the bundle as JSON: sub-phase timelines, lock-wait deltas,
  trace_id exemplars;
- ``/healthz`` — health probe. Without a ``health_provider`` it is a bare
  liveness check (200 ``ok``); with one (a server's ``health``) it returns
  200 ``ok`` only while the provider reports ``SERVING``, and 503 with the
  state name (``DEGRADED``/``DRAINING``) otherwise, so a load balancer can
  take a degraded or draining server out of rotation.

It binds ``127.0.0.1`` by default and ``port=0`` to an ephemeral port
(returned by ``start()``). The handler threads are daemons: the exposition
never keeps a finished process alive.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from .metrics import REGISTRY, Registry
from .stepline import debug_snapshot as stepline_debug_snapshot
from .trace import FLIGHT_RECORDER


def write_ignoring_disconnect(wfile, data: bytes, flush: bool = False) -> bool:
    """Write a response body tolerating the client vanishing mid-write.

    A scraper that times out, a load balancer health probe that closes
    early, an SSE consumer that navigates away — all surface here as
    ``BrokenPipeError``/``ConnectionResetError`` (or a bare ``OSError``
    from a half-torn socket). That is NORMAL traffic at an exposition
    endpoint, not an error: swallow it and report False instead of
    splattering a handler-thread traceback per disconnect. ``flush=True``
    additionally flushes (SSE streaming needs each event on the wire
    now), under the same policy."""
    try:
        wfile.write(data)
        if flush:
            wfile.flush()
        return True
    except (BrokenPipeError, ConnectionResetError, OSError):
        return False


class MetricsServer:
    def __init__(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        registry: Optional[Registry] = None,
        statz_extra: Optional[Dict[str, Callable[[], object]]] = None,
        health_provider: Optional[Callable[[], str]] = None,
    ):
        self.registry = registry if registry is not None else REGISTRY
        self._extra: Dict[str, Callable[[], object]] = dict(statz_extra or {})
        self._health = health_provider
        self._profilez: Optional[
            Callable[[Optional[int], float], dict]
        ] = None
        self._httpd = ThreadingHTTPServer(
            (host, port), self._handler_class()
        )
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="obs-http"
        )
        self._started = False

    def add_statz(self, name: str, provider: Callable[[], object]) -> None:
        """Register (or replace) a named JSON provider under ``/statz`` —
        e.g. the live server's counters, per-replica queue depths."""
        self._extra[name] = provider

    def set_profilez_provider(
        self, provider: Optional[Callable[[Optional[int], float], dict]]
    ) -> None:
        """Attach (or detach with ``None``) the ``/profilez`` deep-capture
        source: ``provider(steps, wait_s)`` with ``steps=None`` for the
        bare ring-tail view, or an int to arm an N-step capture and block
        up to ``wait_s`` for it. A caller wires the live server's
        ``stepline_capture``/``stepline_snapshot`` here; without a
        provider, ``/profilez`` falls back to the process-wide
        ``obs.stepline.debug_snapshot`` (read-only, no arming)."""
        self._profilez = provider

    def set_health_provider(
        self, provider: Optional[Callable[[], str]]
    ) -> None:
        """Attach (or detach with ``None``) the live health source —
        a zero-arg callable returning the server's state name
        (``SERVING``/``DEGRADED``/``DRAINING``). ``/healthz`` turns 503 for
        anything but ``SERVING``."""
        self._health = provider

    def _health_response(self) -> tuple:
        """(status_code, body) for ``/healthz``. A provider that raises
        reports 503 rather than taking the endpoint down — an unreadable
        health state IS unhealthy as far as a load balancer is concerned."""
        if self._health is None:
            return 200, b"ok\n"
        try:
            state = str(self._health())
        except Exception as e:  # noqa: BLE001 — surfaced as unhealthy
            return 503, f"unhealthy: health provider failed: {e}\n"[:500].encode()
        if state == "SERVING":
            return 200, b"ok\n"
        return 503, f"{state}\n".encode()

    def start(self) -> int:
        if not self._started:
            self._thread.start()
            self._started = True
        return self.port

    def stop(self) -> None:
        if self._started:
            self._httpd.shutdown()
            self._started = False
        self._httpd.server_close()

    # ------------------------------------------------------------ internals

    def _statz_payload(self) -> dict:
        payload: dict = {"metrics": self.registry.json_snapshot()}
        for name, provider in list(self._extra.items()):
            try:
                payload[name] = provider()
            except Exception as e:  # noqa: BLE001 — a dead provider must
                # not take the whole stats page down
                payload[name] = {"error": str(e)[:200]}
        return payload

    def _debugz_payload(self) -> dict:
        """One self-contained postmortem bundle. Health reads through the
        same provider-failure policy as ``/healthz`` (an unreadable state is
        reported, not raised), and every ``/statz`` provider rides along —
        the bundle must be maximally informative precisely when parts of
        the daemon are broken."""
        health = None
        if self._health is not None:
            try:
                health = str(self._health())
            except Exception as e:  # noqa: BLE001 — report, don't die
                health = f"unreadable: {e}"[:200]
        bundle = self._statz_payload()
        bundle.update(
            generated_at=time.time(),
            health=health,
            recent_spans=FLIGHT_RECORDER.snapshot(),
            recent_steps=stepline_debug_snapshot(),
        )
        return bundle

    def _profilez_payload(self, query: str) -> tuple:
        """(status_code, payload) for ``/profilez``. ``?steps=N`` arms a
        deep capture through the attached provider (blocking up to
        ``wait_s``, default 5 s, capped at 60 — an exposition handler must
        not park forever); a bare GET is the non-arming ring view."""
        params = urllib.parse.parse_qs(query)
        steps: Optional[int] = None
        if "steps" in params:
            try:
                steps = int(params["steps"][-1])
                if steps < 1:
                    raise ValueError(steps)
            except ValueError:
                return 400, {"error": "steps must be a positive integer"}
        try:
            wait_s = min(float(params.get("wait_s", ["5.0"])[-1]), 60.0)
        except ValueError:
            return 400, {"error": "wait_s must be a number"}
        if self._profilez is None:
            if steps is not None:
                return 503, {
                    "error": "no profilez provider attached: deep capture "
                    "needs a live server (set_profilez_provider)"
                }
            return 200, {"profilers": stepline_debug_snapshot()}
        try:
            return 200, self._profilez(steps, wait_s)
        except Exception as e:  # noqa: BLE001 — a dead provider must not
            # take the endpoint down
            return 500, {"error": str(e)[:500]}

    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
                path, _, query = self.path.partition("?")
                path = path.rstrip("/") or "/"
                code = 200
                if path == "/metrics":
                    # content negotiation: exemplars are only legal in the
                    # OpenMetrics flavor, so a scraper that asks for it
                    # (modern Prometheus sends this Accept when exemplar
                    # storage is on) gets them; everyone else gets pure
                    # text format 0.0.4, which a strict parser accepts
                    om = "application/openmetrics-text" in (
                        self.headers.get("Accept") or ""
                    )
                    body = server.registry.prometheus_text(
                        openmetrics=om
                    ).encode()
                    ctype = (
                        "application/openmetrics-text; version=1.0.0; "
                        "charset=utf-8"
                        if om else "text/plain; version=0.0.4; charset=utf-8"
                    )
                elif path == "/statz":
                    body = json.dumps(
                        server._statz_payload(), sort_keys=True
                    ).encode()
                    ctype = "application/json"
                elif path == "/debugz":
                    body = json.dumps(
                        server._debugz_payload(), sort_keys=True
                    ).encode()
                    ctype = "application/json"
                elif path == "/profilez":
                    code, payload = server._profilez_payload(query)
                    body = json.dumps(payload, sort_keys=True).encode()
                    ctype = "application/json"
                elif path == "/healthz":
                    code, body = server._health_response()
                    ctype = "text/plain; charset=utf-8"
                else:
                    self.send_error(
                        404,
                        "try /metrics, /statz, /debugz, /profilez or "
                        "/healthz",
                    )
                    return
                try:
                    self.send_response(code)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                except (BrokenPipeError, ConnectionResetError, OSError):
                    return  # client left before the headers went out
                write_ignoring_disconnect(self.wfile, body)

            def handle_one_request(self):
                # the request LINE read can also hit a reset socket; same
                # policy as the body write — a disconnect is not an error
                try:
                    super().handle_one_request()
                except (BrokenPipeError, ConnectionResetError):
                    self.close_connection = True

            def log_message(self, *a):  # silence per-request stderr spam
                pass

        return Handler
