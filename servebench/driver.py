"""Drives the port's in-process server (``PipelineServer.submit`` / ``step``,
the serial loop) with a mix's requests, and keeps what the metrics read.

A closed loop (``clients``) fills every client's first request during set-up
and opens the window once all of them are admitted; then each client sends
its next request when its last one ends. An open loop submits each arrival
when it falls due (its ``due`` time, from which its latencies count) from
``lead_seconds`` before the window opens.

Every stamp is the host's ``time.perf_counter``, the clock of the program's
own ``Request`` stamps.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

STEPLINE_EVERY = 128  # steps between reads of the server's 512-step ring
HELD_EVERY = 16  # steps between samples of what the running requests hold


def evictions(stats: dict) -> int:
    """Nodes the prefix cache has evicted from the device, to any tier."""
    return sum(int(stats[k]) for k in ("evictions_to_host", "evictions_to_disk",
                                        "evictions_dropped"))


@dataclasses.dataclass
class Rec:
    """One request the run sent."""

    spec: object  # gen.Spec
    req: object  # the port's Request
    due: float
    submitted: float
    first_in_step: Optional[tuple] = None  # (step start, step end) that applied the first token
    marks: dict = dataclasses.field(default_factory=dict)  # tokens applied at named moments

    @property
    def plen(self) -> int:
        return int(len(self.spec.prompt))

    @property
    def ok(self) -> bool:
        return self.req.done and self.req.error is None

    def tokens_at(self, mark: str) -> int:
        return self.marks.get(mark, 0)


class Driver:
    def __init__(self, srv, traffic, mix: dict, clock=time.perf_counter):
        self.srv = srv
        self.traffic = traffic
        self.mix = mix
        self.clock = clock
        self.closed = mix["loop"] == "closed"
        self.recs: list = []
        self.live: list = []
        self.steps: list = []  # (start, end) of every step()
        self.stepline: dict = {}  # step records by their end stamp (wall clock)
        self._stream = traffic.stream()
        self._next = None  # open loop: (due, spec) of the next arrival
        self.occupancy: list = []  # (stamp, rows, live tokens, reserved blocks)

    # -- requests ---------------------------------------------------------

    def submit(self, spec, due: float) -> Rec:
        now = self.clock()
        req = self.srv.submit(
            spec.prompt, spec.max_new, temperature=spec.temperature, seed=spec.seed,
            top_k=spec.top_k, top_p=spec.top_p,
        )
        rec = Rec(spec, req, due, now)
        self.recs.append(rec)
        self.live.append(rec)
        return rec

    def start_schedule(self, t0: float) -> None:
        """Open loop: arrivals from ``t0`` on."""
        spec = next(self._stream)
        self._next = (t0 + spec.gap, spec)

    def _pump(self) -> None:
        now = self.clock()
        while self._next is not None and self._next[0] <= now:
            due, spec = self._next
            self.submit(spec, due)
            nxt = next(self._stream)
            self._next = (due + nxt.gap, nxt)

    # -- the loop ---------------------------------------------------------

    def step(self) -> bool:
        if not self.closed:
            self._pump()
        t0 = self.clock()
        progressed = self.srv.step()
        t1 = self.clock()
        self.steps.append((t0, t1))
        live, self.live = self.live, []  # submit() appends the closed loop's next requests
        for rec in live:
            req = rec.req
            if rec.first_in_step is None and req.first_token_at is not None:
                if not t0 <= req.first_token_at <= t1:
                    raise RuntimeError(
                        f"request {req.id}: first-token stamp {req.first_token_at} lies "
                        f"outside the step that applied it ({t0}, {t1})"
                    )
                rec.first_in_step = (t0, t1)
            if not req.done:
                self.live.append(rec)
            elif self.closed:
                self.submit(next(self._stream), self.clock())
        if len(self.steps) % STEPLINE_EVERY == 0:
            self.read_stepline()
        if len(self.steps) % HELD_EVERY == 0:
            self.occupancy.append((t1, *self.held()))
        if not progressed and not self.closed and self._next is not None:
            time.sleep(max(0.0, min(self._next[0] - self.clock(), 0.002)))
        return progressed

    def held(self) -> tuple:
        """``(rows, live tokens, reserved blocks)`` of the admitted requests
        still running: the tokens their KV holds now, and the blocks the
        server reserves for each at admission (its prompt bucket and budget,
        the final prompt token of a chunked one, in blocks: the rule of the
        server's ``_blocks_needed``), as this harness reckons them."""
        from llm_sharding_tpu_torch.runtime.server import ADMIT_BUCKETS

        server = self.mix["server"]
        bs, chunk = int(server["kv_block_size"]), server.get("prefill_chunk")
        rows = tokens = blocks = 0
        for rec in self.live:
            if rec.req.started_at is None or rec.req.done:
                continue
            bucket = next(b for b in ADMIT_BUCKETS if b >= rec.plen)
            chunked = chunk is not None and rec.plen > int(chunk)
            rows += 1
            tokens += rec.plen + len(rec.req.tokens)
            blocks += -(-(bucket + rec.spec.max_new + int(chunked)) // bs)
        return rows, tokens, blocks

    def read_stepline(self) -> None:
        for r in self.srv.stepline_snapshot():
            self.stepline[r["ts"]] = r

    def fill(self, n: int) -> None:
        """Closed loop: every client's first request, stepped until all of
        them are admitted."""
        for spec in self.traffic.first(n):
            self.submit(spec, self.clock())
        while any(r.req.started_at is None for r in self.recs):
            self.step()

    def fill_cache(self, wave: int, max_waves: int) -> int:
        """Serve the traffic's cache fill in waves of ``wave`` requests until
        the prefix cache has evicted (``prefix_cache_stats``); the waves
        served. The fill's requests are not the run's."""
        fill = self.traffic.fill()
        for n in range(1, max_waves + 1):
            reqs = [self.srv.submit(s.prompt, s.max_new) for s in
                    (next(fill) for _ in range(wave))]
            while not all(r.done for r in reqs):
                self.srv.step()
            bad = [r.error for r in reqs if r.error is not None]
            if bad:
                raise RuntimeError(f"cache fill: a request failed: {bad[0]!r}")
            if evictions(self.srv.prefix_cache_stats()):
                return n
        raise RuntimeError(f"cache fill: no eviction after {max_waves} waves of {wave}")

    def run_until(self, t_end: float) -> None:
        while self.clock() < t_end:
            self.step()

    def mark(self, name: str) -> None:
        """Record every request's applied tokens under ``name``."""
        for rec in self.recs:
            rec.marks[name] = len(rec.req.tokens)
