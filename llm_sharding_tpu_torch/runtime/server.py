"""Continuous-batching server over the paged KV arena or dense per-row
caches, through the engine's pipeline stages: the port of
``llm_sharding_tpu/runtime/server.py`` ``PipelineServer`` (``:885``) with
``submit`` / ``step`` / ``stream`` / ``result`` / ``cancel`` / ``close`` /
``run_until_idle``.

It schedules ``M = num_stages × batch_per_slot`` independent rows, as the
JAX server does (``server.py:1307``); every program runs them through each
stage in turn (``parallel/serve.py``), each stage's layers over its own
arena on its device. Each ``step`` admits queued
requests into free rows, FIFO and gated on free KV blocks
(``server.py:4023-4046``: exhaustion is a queue wait), then runs one
decode step over every live row. The admission path follows
``_use_chunked`` (``server.py:3918-3937``): a prompt bucket above
``prefill_chunk`` is prefilled in chunks through the chunked-prefill
kernel, with one decode step of the other live rows after each chunk; a
smaller bucket is prefilled one-shot through the flash kernel and written
into the row's blocks. A request that can never fit is refused at submit
with ``NeverFits`` (``server.py:2971``). Blocks are released on finish and
on cancel, the table remapped to trash first.

``kv_dtype`` picks the arena's storage (``server.py:1058-1084``): "bf16"
is the engine's own dtype (an f32 engine stays f32), "int8" and "fp8"
store 1-byte codes with per-(block, KV head) scales, quantized at insert
and dequantized inside the paged kernels. ``paged_attn`` picks the paged
attention path once, at construction: "auto" is the CUDA kernels on the
GPU and the plain versions on the CPU, "kernel" insists on the kernels,
"plain" runs the plain versions anywhere (the card's reference run).

Prefix reuse (``server.py:846``, ``:1108-1175``, ``:2957-3089``,
``:3223-3331``, ``:3954-4100``). ``prefix_cache`` "hbm" turns on the
automatic radix cache (``runtime/radix.py``): every submit reuses the
longest cached block-aligned prefix of its prompt, whose blocks are mapped
read-only into the row's table, so only the suffix prefills; a finished
(or cancelled) row's prompt blocks are inserted into the tree instead of
freed, and cold nodes are evicted under pressure. "host" demotes evicted
nodes to a host-RAM pool first, "disk" further spills them to a bounded
pool of files under ``disk_pool_dir`` (adopted again by a fresh server).
A hit with a short suffix admits one-shot (flash with fewer queries than
keys), a long one chunked from column ``prefix``. An explicit
``PrefixHandle`` (``prefill_prefix`` / ``release_prefix``, ``submit(...,
prefix=)``) is the manual path and bypasses the tree.

Resilience (``server.py:38-58``, ``:2941``, ``:3590-3860``):

- **admission control**: ``max_queue=`` bounds the queue (``QueueFull``),
  ``deadline_s=`` / ``default_deadline_s=`` bound a request's life:
  expired in the queue, it is shed at admission; expired in flight, its
  row is cancelled at the next step, one ``serve_cancel_rows`` call per
  sweep. Either way it fails with ``DeadlineExceeded``.
- **containment**: a ``runtime/faults.FaultPlan`` injects faults at
  ``admit_dispatch``, ``chunk_dispatch``, ``log_fetch``, ``request_apply``
  (keyed by request id) and ``snapshot_write``. Transient faults are
  retried with bounded backoff; a failure past its retries fails exactly
  the requests it touched (``RequestFailed`` from ``stream`` / ``result``)
  while the server drops to DEGRADED and keeps serving. The dispatch sites
  retry only injected faults, which raise before the dispatch writes
  anything: the serve programs write the arena and the row state in place,
  so replaying one after a real mid-call failure would write a token's KV
  twice and advance its row twice. A program's tokens stay on the device
  until a read that can be issued again (``log_fetch``) brings them to
  the host, and only then do the host's mirrors follow; a log lost past
  its retries fails the rows it carried, which are stopped on the device.
- **sticky CUDA errors**: a real device fault poisons the process's CUDA
  context, so every later launch fails too. Containment fails the rows it
  touched, as on any failure, but the process cannot serve again: restore
  the last auto-snapshot in a new process (``faults.is_transient`` never
  retries such an error).
- **health**: SERVING / DEGRADED / DRAINING (``health``, the one-hot
  ``server_health_state`` gauge); DEGRADED clears on the next clean step,
  ``close`` fails every queued and in-flight request and goes DRAINING.
- **checkpoints**: ``snapshot`` / ``restore`` (and ``save_snapshot`` /
  ``load_snapshot``, atomic on disk) continue every request of a live
  server in a fresh one, token-identically; ``snapshot_every_s`` /
  ``snapshot_path`` write one at the end of a step once per interval.
- **migration**: ``extract`` takes a live request off this server as
  host-side ``RequestState`` and ``adopt`` re-admits it on another, the
  same ``Request`` object streaming on.

Speculative decoding (``server.py:906-1006``, ``:4473-4607``):
``speculate=K`` replaces each decode step by a verify of every live row
(``_spec_step``): the host drafts up to K tokens per row by n-gram lookup
over the row's prompt and generated ids (``runtime/spec.ngram_draft``,
the width set by the request's ``AdaptiveK``), one forward verifies the
pending token and the drafts through the decode kernel at S = K + 1
(``parallel/serve.serve_verify``), and a variable number of tokens
commits per row. Greedy rows stay token-identical to the non-speculative
server. It is refused together with ``prefill_chunk``, so every admission
is one-shot. The arena's block table covers ``capacity + K + 1`` columns.

Stop strings (``server.py:3870-3910``): ``submit(stop=)`` takes strings,
and needs the engine's ``tokenizer``; every committed token (admission,
decode, each token of a verify run) decodes the generation and, on a hit,
truncates it to the shortest prefix holding the stop and finishes the
request.

Requests and servers feed the port's metrics registry
(``obs/metrics.REGISTRY``) under the JAX package's names.

Observability (``server.py:2197-2330``, ``:2525-2646``, ``:2849``,
``:4612-4830``):

- **spans**: every request carries a ``TraceContext`` (a new root, or a
  child of ``submit(trace=)``) that rides snapshots and ``RequestState``;
  the server emits ``request`` (the root, at finish, cancel or failure),
  ``radix``, ``prefill`` (per request) and ``admit`` (per batch),
  ``decode`` (runs of ``DECODE_SPAN_TOKENS`` committed tokens),
  ``chunk`` / ``apply`` (per step) and ``extract`` / ``adopt`` into the
  process-wide flight recorder and, with ``trace_path=``, a rotating JSONL
  file (``obs/trace.py``);
- **step profiler**: every ``step`` records one ``StepRecord`` into
  ``self.stepline`` (``obs/stepline.py``): the disjoint host phases
  ``admit``, ``radix_plan``, ``table_push``, ``dispatch``, ``fetch``,
  ``apply`` and ``gauge_sweep`` (and the async executor's ``publish`` and
  ``drain``), and the time blocked on the device: the waits on the CUDA
  events of the logs in flight. The gap from the newest log's landing to
  the next program's dispatch is the ``idle_s`` estimate. On the CPU there
  is no event: the program ran inside ``dispatch`` and nothing is blocked.
  ``gauge_sweep_every_s`` paces the load-gauge sweep; ``stepline_capture``
  arms a deep capture, bracketed by ``torch.profiler`` when given
  ``trace_dir``.

The step loop (``server.py:2197-2605``, ``runtime/async_exec.py``). The
row state lives on the device and every program advances it there, so a
decode chunk (``serve_chunk``: ``chunk_cycles`` steps over all rows) is
dispatched without waiting for the previous chunk's tokens. Each program
that commits tokens leaves an entry in ``_pending``: its log, a pinned
host buffer the log is copied into without blocking, and a CUDA event
after that copy. The host applies the entries oldest first (``_drain``),
and its mirrors follow.

- ``pipeline_depth`` (default 1): the serial loop (``inflight_steps=1``)
  leaves that many logs in flight when ``step`` returns, so a step's
  tokens surface one step later and the device computes the next chunk
  while the host reads the last one.
- ``inflight_steps`` (default 1) > 1 splits the step into the executor
  (``step``: publish, admit, dispatch, and a drain only when the window of
  ``inflight_steps`` dispatches is full), a scheduler thread (deadline
  candidates, radix staging, gauge sweep) and a completion sidecar (applies
  logs as they land). ``close`` stops and joins both threads.
- Speculation keeps an effective depth of 1 (the next drafts need the
  committed ids); admission drains every entry first (it needs the
  mirrors), and so do ``snapshot`` and ``extract``.
- ``extract`` settles (drains) whenever logs are pending, at every depth,
  and not only with the async executor as the JAX server does: a sampled
  row's ``torch.Generator`` advances when a program is launched, so an
  unsettled extract would carry draws of steps whose tokens it drops.
- A finish the host decides (stop string, cancel, deadline, containment)
  stops the row on the device before the next dispatch; tokens already in
  flight for it are skipped. A log lost past its retries fails the rows it
  carried, which are stopped on the device (``_contain_lost_log``).

``top_k`` / ``top_p`` are server defaults for requests that give none.

Dense serving (``server.py:1016-1130``): without ``kv_block_size`` /
``kv_blocks`` every row owns a ``capacity``-column cache
(``parallel/serve.make_state``), there is no allocator, and admission
waits only for a free row. One-shot and chunked admission and speculation
work as in paged mode; ``kv_dtype`` int8 / fp8, ``paged_attn`` other than
"auto" and ``prefix_cache`` are refused with the JAX messages. An explicit
``PrefixHandle`` of a dense server owns no blocks. Snapshots carry the
held rows' caches; a dense snapshot restores only into a dense server and
a paged one only into a paged server (``server.py:1911-1925``).

Embedding input (``server.py:2128``): ``submit_embedding`` takes a
prompt's hidden states (``Engine.embed_prompt``) instead of its ids, dense
or paged; such a request admits one-shot, only beside other embedding
requests, never touches the prefix cache, and migrates with its
embeddings (the adopter embeds the generated tail itself).

``submit(tenant=)`` (``server.py:1568``): the ingress's tenant rides on the
request, into its ``request`` span, snapshots and ``RequestState``.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import glob
import json
import logging
import os
import shutil
import time
import weakref
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..analysis.lockorder import named_lock
from ..models.cache import POS_SENTINEL
from ..models.stack import full_heads
from ..obs.metrics import (
    ADMIT_BUCKET_USED, ARENA_BYTES, ATTN_BACKEND, ATTN_BACKENDS, ATTN_BLOCKS_READ,
    DEFAULT_RATE_BUCKETS, KV_BLOCKS_IN_USE, KV_BLOCKS_TOTAL, KV_DISK_TIER_BLOCKS,
    KV_HOST_TIER_BLOCKS, KV_WASTE_FRAC, PREFILL_BLOCKS_READ, PREFIX_HIT_RATE, PREFIX_HIT_TOKENS,
    CP_STREAM_SHARDS, REGISTRY, set_prefill_path,
)
from ..obs.stepline import StepProfiler
from ..obs.trace import TraceContext, TraceWriter, emit_span
from ..ops.paged_attention import decode_block_size_ok
from ..ops.quant import KV_DTYPES, fp8_kv_supported, kv_storage_dtype
from ..ops.sampling import validate_top_p
from ..parallel import serve as serve_ops
from .async_exec import INFLIGHT_STEPS, SCHEDULER_LAG, _CompletionSidecar, _StepScheduler
from .blocks import BlockAllocator, ShardedBlockAllocator
from .faults import backoff_delays, is_transient
from .radix import RadixCache
from .spec import AdaptiveK, count_accepted, ngram_draft, observe

logger = logging.getLogger(__name__)

# Admission prompt buckets (``server.py:317``).
ADMIT_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768)

#: The port's snapshot format. Its own: neither package reads the other's
#: snapshots (the arena travels as raw views, the sampling state as torch
#: generator states). ``serve_kwargs`` options added later (the step-loop
#: knobs, ``cp``) restore with their defaults when a snapshot lacks them.
SNAPSHOT_FORMAT = 1
# arena blocks moved per device<->host copy by snapshot and restore: the
# device holds one such chunk beside the arena, never a second arena
_ARENA_CHUNK_BLOCKS = 32
# the row state the programs keep on the device (a snapshot reads it)
_DEVICE_ROW_STATE = ("tok", "pos_slots", "write_off", "lengths", "done", "budget")
#: committed tokens per ``decode`` span (``server.py:312``): a span per run
#: of this many tokens, the remainder flushed at the request's finish
DECODE_SPAN_TOKENS = 32
# seconds a bounded wait on a log's CUDA event sleeps between polls
_POLL_S = 5e-4

# -- health states (``server.py:97-101``) ------------------------------------
SERVING = "SERVING"  # admitting and decoding normally
DEGRADED = "DEGRADED"  # a containment event: some requests failed, the rest serve
DRAINING = "DRAINING"  # closed: no admits, queued and in-flight requests failed
_HEALTH_SEVERITY = {SERVING: 0, DEGRADED: 1, DRAINING: 2}


class NeverFits(ValueError):
    """The request can never be admitted: its prompt bucket plus budget
    exceeds the server's capacity or position limit, or it needs more KV
    blocks than the pool holds."""


class QueueFull(RuntimeError):
    """``submit`` rejected: the bounded queue (``max_queue=``) is full."""


class ServerClosed(RuntimeError):
    """The server was closed: submits are rejected and live requests were
    failed with this error."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed: shed from the queue at admission, or
    cancelled at the next step if it was decoding."""


class RequestFailed(RuntimeError):
    """Raised from ``stream`` / ``result`` for a request that failed (its
    cause is chained: containment, deadline, shutdown)."""

    def __init__(self, msg: str, request=None):
        super().__init__(msg)
        self.request = request


# -- context-parallel serving (JAX ``server.py:241-252``) --------------------
CP_SHARDS = REGISTRY.gauge(
    "server_cp_shards",
    "Context-parallel degree of the live server (1 = arena unsharded)",
)
CP_COMBINE_SECONDS = REGISTRY.histogram(
    "server_cp_combine_seconds",
    "Host-observed wall time of each cp > 1 decode dispatch (trace + "
    "enqueue of the serve_chunk program containing the cross-shard "
    "softmax combine; device execution is async — compare against cp=1 "
    "for the combine's dispatch-side overhead)",
)

# -- serving telemetry (``server.py:130-300``) --------------------------------
_M_QUEUE_WAIT = REGISTRY.histogram(
    "server_queue_wait_seconds", "Submission-to-admission wait per request",
)
_M_TTFT = REGISTRY.histogram(
    "server_ttft_seconds",
    "Submission to first committed token per request (includes queue wait)",
)
_M_INTERTOKEN = REGISTRY.histogram(
    "server_intertoken_seconds",
    "Host-visible gap between a request's consecutive committed tokens",
)
_M_REQUEST = REGISTRY.histogram(
    "server_request_seconds", "Submission-to-completion wall time per request",
)
_M_TOK_S = REGISTRY.histogram(
    "server_request_tok_s",
    "Per-request decode rate over its admission-to-finish window",
    buckets=DEFAULT_RATE_BUCKETS,
)
_M_QUEUE_DEPTH = REGISTRY.gauge(
    "server_queue_depth", "Requests waiting for a free slot, summed over live servers",
)
_M_ACTIVE = REGISTRY.gauge(
    "server_slots_active",
    "Slot rows holding a live (not done) request, summed over live servers",
)
_M_FETCH_FAIL = REGISTRY.counter(
    "server_fetch_failures_total",
    "Device-to-host token reads that raised (decode steps, admission tokens)",
)
_M_REJECTED = REGISTRY.counter(
    "server_rejected_total",
    "Submits rejected at admission control, by reason (queue_full = max_queue "
    "reached, closed = server shut down)",
    labels=("reason",),
)
_M_DEADLINE = REGISTRY.counter(
    "server_deadline_expired_total",
    "Requests whose deadline expired, by where they were caught (queued = shed "
    "at admit time, in_flight = cancelled at a step boundary)",
    labels=("where",),
)
_M_RETRIES = REGISTRY.counter(
    "server_retries_total", "Transient-failure retries of a serving operation, by site",
    labels=("site",),
)
_M_CONTAINED = REGISTRY.counter(
    "server_failures_contained_total",
    "Persistent failures contained to their affected requests, by site",
    labels=("site",),
)
_M_SNAPSHOTS = REGISTRY.counter(
    "server_snapshots_total", "Auto-snapshots written successfully (snapshot_every_s=)",
)
_M_SNAPSHOT_FAIL = REGISTRY.counter(
    "server_snapshot_failures_total",
    "Auto-snapshot attempts that failed (kept serving; retried next interval)",
)
_M_HEALTH = REGISTRY.state_gauge(
    "server_health_state",
    "Serving health state machine (worst across live servers): exactly one "
    "state label is 1",
    states=(SERVING, DEGRADED, DRAINING),
)
# every live server in the process: the load gauges are sums over them
_LIVE_SERVERS: "weakref.WeakSet" = weakref.WeakSet()


def _update_load_gauges() -> None:
    """Recompute the process-wide load and KV gauges from every live server
    (``server.py:169``): queue depth, active rows, open servers by decode
    attention backend, the paged pool's blocks and waste, arena bytes by
    dtype, the prefix cache's tiers and hit rate."""
    queued = active = kv_total = kv_used = kv_slots = kv_live = 0
    host_blocks = disk_blocks = hit_tok = elig_tok = 0
    arena = dict.fromkeys(KV_DTYPES, 0)
    backends = dict.fromkeys(ATTN_BACKENDS, 0)
    for s in list(_LIVE_SERVERS):
        queued += len(s._queue)
        live = [i for i, r in enumerate(s._req) if r is not None and not r.done]
        active += len(live)
        if not s._closed:
            arena[s.kv_dtype] += s.arena_bytes()
            backends[s.attn_path] += 1
        if s._alloc is None:
            continue  # dense: no pool
        kv_total += s._alloc.capacity_blocks
        kv_used += s._alloc.in_use
        kv_slots += (s._alloc.in_use - s._alloc.cache_cold) * s.kv_block_size
        kv_live += int(sum(s.state.mirror_len[i] for i in live))
        if s._radix is not None:
            host_blocks += s._radix.host_blocks
            disk_blocks += s._radix.disk_blocks
            hit_tok += s._radix.hit_tokens
            elig_tok += s._radix.eligible_tokens
    _M_QUEUE_DEPTH.set(queued)
    _M_ACTIVE.set(active)
    for name, nbytes in arena.items():
        ARENA_BYTES.labels(dtype=name).set(nbytes)
    for name, n in backends.items():
        ATTN_BACKEND.labels(backend=name).set(n)
    KV_BLOCKS_TOTAL.set(kv_total)
    KV_BLOCKS_IN_USE.set(kv_used)
    KV_HOST_TIER_BLOCKS.set(host_blocks)
    KV_DISK_TIER_BLOCKS.set(disk_blocks)
    PREFIX_HIT_RATE.set(hit_tok / elig_tok if elig_tok else 0.0)
    KV_WASTE_FRAC.set(0.0 if kv_slots == 0 else max(0.0, 1.0 - kv_live / kv_slots))


def _update_health_gauge() -> None:
    """The worst state across live, open servers (``server.py:298``);
    closed servers vote only when every server is closed."""
    states = [s._health for s in list(_LIVE_SERVERS) if not s._closed]
    if not states:
        states = [s._health for s in list(_LIVE_SERVERS)] or [SERVING]
    _M_HEALTH.set_state(max(states, key=_HEALTH_SEVERITY.__getitem__))


@dataclasses.dataclass
class Counters:
    """Per-server running totals (``server.py:323``). ``inc`` bumps the field
    and mirrors it into the process-wide ``server_<field>_total`` counter;
    direct field writes (restore) do not mirror."""

    requests_submitted: int = 0
    requests_completed: int = 0
    requests_cancelled: int = 0
    requests_failed: int = 0  # deadline expiry, containment, shutdown
    tokens_generated: int = 0
    admissions: int = 0
    chunks: int = 0

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)

    def inc(self, field: str, n: int = 1) -> None:
        setattr(self, field, getattr(self, field) + n)
        _FIELD_COUNTERS[field].inc(n)

    @classmethod
    def from_snapshot(cls, snap: dict) -> "Counters":
        """Unknown keys are ignored, missing fields default to 0."""
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in snap.items() if k in known})


_FIELD_COUNTERS = {
    f.name: REGISTRY.counter(
        f"server_{f.name}_total", f"Process total of Counters.{f.name} across live servers",
    )
    for f in dataclasses.fields(Counters)
}


# -- serve-state checkpoints on disk (``server.py:475-695``) ------------------

def save_snapshot(snap: dict, path: str) -> None:
    """Write a ``PipelineServer.snapshot`` to the directory ``path``:
    ``state.npz`` for every array (the arena's bytes as their raw views,
    no pickling), ``meta.json`` for the rest.

    Atomic: everything lands in a temporary sibling directory, each file
    and the directory fsync'd, which is renamed into place. A previous
    snapshot at ``path`` is first parked at ``path.old.<pid>`` and removed
    once the new one is in place, so ``path`` or the parked copy holds a
    complete snapshot at every instant (``load_snapshot`` recovers the
    parked one)."""
    path = os.path.normpath(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays: dict = {}

    def enc_reqs(kind: str, reqs) -> list:
        out = []
        for i, d in enumerate(reqs):
            if d is None:
                out.append(None)
                continue
            e = {}
            for k, v in d.items():
                if isinstance(v, np.ndarray):
                    arrays[f"{kind}.{i}.{k}"] = v
                    e.setdefault("arrays", []).append(k)
                else:
                    e[k] = v
            out.append(e)
        return out

    for k, v in snap["state"].items():
        arrays[f"state.{k}"] = v
    for k, v in snap["arena"].items():
        arrays[f"arena.{k}"] = v
    if snap["paged"] is not None:
        arrays["paged.tables"] = snap["paged"]["tables"]
    radix_meta = None
    if snap["radix"] is not None:
        arrays.update(snap["radix"]["arrays"])
        radix_meta = {"nodes": snap["radix"]["nodes"], "counters": snap["radix"]["counters"]}
    meta = {k: snap[k] for k in ("format", "serve_kwargs", "arena_dtype", "rng_device",
                                 "next_id", "counters")}
    # the topology restore checks (a file without them restores as 1, 1)
    meta.update({k: snap.get(k, 1) for k in ("num_stages", "tensor_parallel")})
    meta.update(
        paged=None if snap["paged"] is None else {
            "row_blocks": snap["paged"]["row_blocks"], "row_shared": snap["paged"]["row_shared"],
        },
        radix=radix_meta, rows=enc_reqs("rows", snap["rows"]),
        queue=enc_reqs("queue", snap["queue"]),
    )
    np.savez(os.path.join(tmp, "state.npz"), **arrays)
    with open(os.path.join(tmp, "state.npz"), "rb") as f:
        os.fsync(f.fileno())  # the data is durable before the rename is
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    parent = os.path.dirname(os.path.abspath(path))
    if os.path.isdir(path):
        old = f"{path}.old.{os.getpid()}"
        if os.path.isdir(old):
            shutil.rmtree(old)
        os.rename(path, old)
        os.rename(tmp, path)
        _fsync_dir(parent)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.rename(tmp, path)
        _fsync_dir(parent)


def _fsync_dir(path: str) -> None:
    """Best-effort directory fsync (makes renames durable); a filesystem
    that refuses it is skipped, not an error."""
    try:
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def load_snapshot(path: str) -> dict:
    """Read a ``save_snapshot`` directory back into ``restore`` input. When
    ``path`` is missing, the newest parked ``path.old.<pid>`` (a writer
    that died inside the swap) is read instead."""
    if not os.path.exists(os.path.join(path, "meta.json")):
        parked = sorted(glob.glob(f"{os.path.normpath(path)}.old.*"), key=os.path.getmtime)
        if parked:
            logger.warning("snapshot %s missing; recovering the parked previous snapshot %s",
                           path, parked[-1])
            path = parked[-1]
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "state.npz")) as z:
        arrays = {k: z[k] for k in z.files}

    def dec_reqs(kind: str, reqs) -> list:
        out = []
        for i, e in enumerate(reqs):
            if e is None:
                out.append(None)
                continue
            d = {k: v for k, v in e.items() if k != "arrays"}
            for k in e.get("arrays", []):
                d[k] = arrays[f"{kind}.{i}.{k}"]
            out.append(d)
        return out

    def section(prefix: str) -> dict:
        return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}

    radix = None
    if meta["radix"] is not None:
        # the tree's own keys ("radix.<i>.key", "radix.<i>.kv<j>") are kept whole
        radix = dict(meta["radix"],
                     arrays={k: v for k, v in arrays.items() if k.startswith("radix.")})
    return dict(
        {k: meta[k] for k in ("format", "serve_kwargs", "arena_dtype", "rng_device",
                              "next_id", "counters")},
        num_stages=meta.get("num_stages", 1), tensor_parallel=meta.get("tensor_parallel", 1),
        state=section("state."), arena=section("arena."),
        paged=None if meta["paged"] is None else dict(meta["paged"], tables=arrays["paged.tables"]),
        radix=radix, rows=dec_reqs("rows", meta["rows"]), queue=dec_reqs("queue", meta["queue"]),
    )


def _validate_prefix_cache(prefix_cache, host_pool_blocks, disk_pool_dir, disk_pool_blocks):
    """The JAX server's checks of the prefix-cache options, with its
    messages (``server.py:1119-1159``)."""
    if prefix_cache not in ("off", "hbm", "host", "disk"):
        raise ValueError(
            f"prefix_cache must be off, hbm, host or disk, got {prefix_cache!r}"
        )
    if host_pool_blocks and prefix_cache not in ("host", "disk"):
        raise ValueError(
            "host_pool_blocks sizes the host-RAM tier — it needs prefix_cache='host' or "
            f"'disk' (got prefix_cache={prefix_cache!r})"
        )
    if host_pool_blocks < 0:
        raise ValueError(f"host_pool_blocks must be >= 0, got {host_pool_blocks}")
    if (disk_pool_dir or disk_pool_blocks) and prefix_cache != "disk":
        raise ValueError(
            "disk_pool_dir/disk_pool_blocks size the on-disk tier — they need "
            f"prefix_cache='disk' (got prefix_cache={prefix_cache!r})"
        )
    if prefix_cache == "disk" and not disk_pool_dir:
        raise ValueError(
            "prefix_cache='disk' needs disk_pool_dir: the bounded pool of "
            "memory-mapped entry files is the persistent artifact cold nodes spill into"
        )
    if disk_pool_blocks < 0:
        raise ValueError(f"disk_pool_blocks must be >= 0, got {disk_pool_blocks}")


def _read_arena_blocks(state, blocks) -> tuple:
    """Device→host copy of arena blocks for the tree's host tier
    (``server.py:3176``): the dispatch half, then the copy's wait."""
    return serve_ops.read_arena_blocks(state, list(blocks))


def _write_arena_blocks(state, blocks, k_host, v_host, *scales) -> None:
    """Host→device restore of demoted blocks into fresh arena blocks
    (``server.py:3189``), codes and scales byte-exact, each stage taking
    its layers; queued before the admission that reads them."""
    serve_ops.write_state_blocks(state, list(blocks), k_host, v_host, *scales)


def _tenant_field(req) -> dict:
    """The ``request`` span's ``tenant`` field of ingress traffic
    (``server.py:3648``, ``:4795``): none for a request without one."""
    return {} if req.tenant is None else {"tenant": req.tenant}


def _as_embeds(x, dtype: torch.dtype) -> np.ndarray:
    """Hidden states (numpy, list or a tensor on any device) as the f32
    numpy array a request keeps, rounded through ``dtype`` (the engine's):
    exact to what a bf16 or f32 admission feeds the layers."""
    t = x.detach() if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x, np.float32))
    return t.to(dtype).to("cpu", torch.float32).numpy()


class _InFlight:
    """One dispatched program's log on its way to the host: an entry of
    ``PipelineServer._pending`` (the JAX server's ``(kind, _Prefetched,
    meta)``, ``server.py:368``). On the card the log is copied into a
    pinned host buffer by a ``non_blocking`` copy queued right behind the
    program, and a CUDA event recorded after that copy says when its bytes
    have landed: nothing waits at dispatch. On the CPU the program ran
    inside the dispatch and its log is on the host already."""

    __slots__ = ("kind", "log", "host", "event", "meta", "done_at", "rng_marks")

    def __init__(self, kind: str, log: torch.Tensor, meta, rng_marks=None):
        self.kind = kind  # "admit", "chunk" or "spec"
        self.log = log
        self.meta = meta  # admit, chunk: [(row, req)]; spec: [(row, req, k, draft)]
        # {row: generator state before the program drew} of its sampled
        # rows (``_rng_marks``): what an unsettled extract carries, so the
        # adopter redraws the dropped tokens as the source drew them
        self.rng_marks = rng_marks
        # perf_counter when the host first saw the log landed: the
        # device-idle estimate's start
        self.done_at: Optional[float] = None
        if log.device.type == "cuda":
            self.host = torch.empty(log.shape, dtype=log.dtype, pin_memory=True)
            self.host.copy_(log, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = log, None

    def landed(self) -> bool:
        """Whether the log is on the host, without waiting."""
        if self.done_at is None:
            if self.event is not None and not self.event.query():
                return False
            self.done_at = time.perf_counter()
        return True

    def wait_landed(self, timeout: Optional[float] = None) -> bool:
        """Wait until the log is on the host; True once it has landed.
        Without ``timeout``: the CUDA event's wait, which releases the
        interpreter lock (bounded by the programs queued ahead of the copy,
        which the device always finishes). With one: poll the event, asleep
        between polls, for at most ``timeout`` seconds (the sidecar's wait,
        which ``close()`` must not queue behind)."""
        if self.event is not None and self.done_at is None:
            if timeout is None:
                self.event.synchronize()
            else:
                end = time.perf_counter() + timeout
                while not self.event.query():
                    if time.perf_counter() >= end:
                        return False
                    time.sleep(_POLL_S)
        if self.done_at is None:
            self.done_at = time.perf_counter()
        return True

    def read(self) -> np.ndarray:
        """The log on the host, once landed."""
        return self.host.numpy()


class PrefixHandle:
    """The KV of a shared prefix, prefilled once by
    ``PipelineServer.prefill_prefix`` (``server.py:846``). Requests
    submitted with it (``submit(suffix_ids, prefix=handle)``) skip the
    prefix's prefill: each admission seeds its rows from ``kv`` and
    prefills only the suffix at positions ``n + i``.

    The handle owns ``spx / block_size`` refcounted arena blocks, mapped
    read-only into every row admitted with it; an admission writes them
    with the handle's KV, the same bytes each time. ``release_prefix``
    drops the handle's references; rows still mapping the blocks keep them
    until they finish. Block ids index one server's pool, so the handle
    remembers (weakly) the server that made it. A handle does not outlive
    its process: a restored row admitted with one holds a released stand-in
    (``blocks`` None) that records the prefix's layout."""

    __slots__ = ("kv", "n", "spx", "blocks", "owner")

    def __init__(self, kv, n: int, spx: int, blocks=None, owner=None):
        self.kv = kv  # (k [L, 1, spx, Nkv, D], v, pos [1, spx]) on the device
        self.n = n  # real prefix length: suffix positions resume here
        self.spx = spx  # padded prefix bucket, a multiple of the block size
        self.blocks = blocks  # the shared arena block ids; None once released
        self.owner = None if owner is None else weakref.ref(owner)

    def owned_by(self, srv) -> bool:
        return self.owner is not None and self.owner() is srv


class Request:
    """A queued or in-flight generation request."""

    def __init__(self, rid: int, prompt: np.ndarray, max_new: int, temperature: float,
                 seed: int, top_k: int, top_p: float, prefix: Optional[PrefixHandle] = None,
                 deadline_s: Optional[float] = None, stop: tuple = (),
                 trace: Optional[TraceContext] = None, embeds: Optional[np.ndarray] = None,
                 tenant: Optional[str] = None):
        self.id = rid
        self.prompt = prompt  # with a handle: the suffix only; embeddings: empty
        # [S, H] f32 hidden states of an embedding request (exact for a
        # bf16 or f32 engine), else None
        self.embeds = embeds
        self.prompt_len = int(prompt.shape[0] if embeds is None else embeds.shape[0])
        self.tenant = tenant  # the ingress tenant that sent it, or None
        self.max_new = max_new
        self.temperature = temperature
        self.seed = seed
        self.top_k = top_k
        self.top_p = top_p
        self.prefix = prefix
        self.stop = stop  # stop strings, checked on the decoded text
        self.stop_checked = 0  # tokens already scanned for them
        self.spec_k: Optional[AdaptiveK] = None  # set by a speculative server
        # a radix match taken (pinned) one step ahead of admission
        self.staged_radix = None
        self.tokens: list[int] = []
        self.done = False
        self.row: Optional[int] = None
        self.error: Optional[BaseException] = None
        # migration: leading entries of ``tokens`` already folded into
        # ``prompt`` by ``adopt``, and the generator state it carried in
        # (consumed by the next admission)
        self.baked = 0
        self.carried_rng: Optional[np.ndarray] = None
        # the request's span identity: a child of the caller's context, or
        # a fresh root trace
        self.trace = trace.child() if trace is not None else TraceContext.new()
        # (tokens at the last decode span, its perf_counter): the bucketed
        # decode-span cursor
        self.decode_mark: Optional[tuple] = None
        self.submitted_at = time.perf_counter()
        self.deadline_at = None if deadline_s is None else self.submitted_at + deadline_s
        self.started_at: Optional[float] = None
        self.first_token_at: Optional[float] = None
        self.last_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None


@dataclasses.dataclass
class RequestState:
    """Portable host-side state of a live request (``server.py:788``):
    what another server needs to continue it where this one left it
    (``PipelineServer.extract`` builds it, ``adopt`` re-admits it). It holds
    no device tensor and takes no device read.

    ``prompt`` is the resumed prompt: the original ids with every token
    generated so far appended, so the adopter's ordinary admission
    recomputes the row's KV. ``rng`` is a sampled row's
    ``torch.Generator`` state after its last draw (a CUDA generator's state
    lives on the host), ``rng_device`` the device type of that generator:
    a sampled request migrates only between servers on one device type, a
    greedy one anywhere. Both are None for greedy and never-admitted
    requests. ``trace`` is the request's span identity: the adopter's spans
    join the same tree. An embedding request carries its original
    ``embeds`` and an empty ``prompt``; the adopter embeds ``tail``
    (``server.py:3431-3456``)."""

    prompt: np.ndarray  # resumed ids (with a prefix handle: the suffix + tail; embeddings: empty)
    tail: np.ndarray  # generated ids not yet folded into a prompt
    remaining: int  # new-token budget still unspent
    rng: Optional[np.ndarray]  # uint8 generator state, or None
    rng_device: Optional[str]
    prefix: Optional[PrefixHandle]  # the source server's handle
    stop: tuple = ()  # the request's stop strings
    trace: Optional[TraceContext] = None
    embeds: Optional[np.ndarray] = None  # an embedding request's original [S, H] states
    tenant: Optional[str] = None


class PipelineServer:
    """Continuous batching over an ``Engine``'s weights on its device."""

    def __init__(
        self,
        engine,
        *,
        capacity: int = 1024,
        batch_per_slot: int = 1,
        chunk_cycles: int = 1,
        top_k: int = 0,
        top_p: float = 1.0,
        prefill_chunk: Optional[int] = None,
        pipeline_depth: int = 1,
        inflight_steps: int = 1,
        kv_block_size: Optional[int] = None,
        kv_blocks: Optional[int] = None,
        kv_dtype: str = "bf16",
        paged_attn: str = "auto",
        prefix_cache: str = "off",
        host_pool_blocks: int = 0,
        disk_pool_dir: Optional[str] = None,
        disk_pool_blocks: int = 0,
        max_queue: Optional[int] = None,
        default_deadline_s: Optional[float] = None,
        fault_plan=None,
        fault_retries: int = 3,
        fault_backoff_s: float = 0.01,
        retryable_exceptions: tuple = (),
        snapshot_every_s: Optional[float] = None,
        snapshot_path: Optional[str] = None,
        speculate: int = 0,
        spec_ngram: int = 3,
        trace_path: Optional[str] = None,
        gauge_sweep_every_s: float = 0.0,
        cp: int = 1,
    ):
        if cp < 1:
            raise ValueError(f"cp must be >= 1, got {cp}")
        if (kv_block_size is None) != (kv_blocks is None):
            raise ValueError(
                f"kv_block_size and kv_blocks go together (got kv_block_size="
                f"{kv_block_size!r}, kv_blocks={kv_blocks!r})"
            )
        paged = kv_block_size is not None
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
        # dense serving refuses what lives per arena block (server.py:1062,
        # :1098, :1125), with the JAX messages
        if kv_dtype != "bf16" and not paged:
            raise ValueError(
                f"kv_dtype={kv_dtype!r} needs paged KV serving (set "
                "kv_block_size/kv_blocks): quantization scales live per "
                "arena block — dense per-row reservations have no blocks"
            )
        tp = engine.tensor_parallel
        if kv_dtype != "bf16" and tp > 1:
            raise NotImplementedError(
                f"kv_dtype={kv_dtype!r} with tensor_parallel={tp}: "
                "the per-block-per-head scale arenas are not heads-sharded "
                "yet — serve quantized KV on pp (or dp×pp) meshes, or keep "
                "kv_dtype='bf16' under tp"
            )
        if paged_attn != "auto" and not paged:
            raise ValueError(
                "paged_attn is only meaningful with paged KV serving "
                "(set kv_block_size/kv_blocks); dense decode has no block "
                "tables to stream"
            )
        if prefix_cache != "off" and not paged:
            raise ValueError(
                "prefix_cache needs paged KV serving (set kv_block_size/"
                "kv_blocks): the cache shares refcounted arena blocks — "
                "dense per-row reservations have nothing to share"
            )
        if kv_dtype == "fp8" and not fp8_kv_supported(engine.device):
            raise ValueError(
                f"kv_dtype='fp8': {engine.device} cannot serve float8_e4m3fn KV (the "
                "kernels need compute capability 9.0); use kv_dtype='int8'"
            )
        if paged_attn not in ("auto", "kernel", "plain"):
            raise ValueError(f"paged_attn must be auto, kernel or plain, got {paged_attn!r}")
        if paged_attn == "kernel" and engine.device.type != "cuda":
            raise ValueError(
                f"paged_attn='kernel' requires a CUDA device (the engine is on "
                f"{engine.device}); use paged_attn='auto' or 'plain'"
            )
        if prefill_chunk is not None and (prefill_chunk < 1 or prefill_chunk & (prefill_chunk - 1)):
            raise ValueError("prefill_chunk must be a power of two")
        if paged and (kv_block_size < 1 or kv_block_size & (kv_block_size - 1)):
            raise ValueError(f"kv_block_size must be a power of two, got {kv_block_size}")
        _validate_prefix_cache(prefix_cache, host_pool_blocks, disk_pool_dir, disk_pool_blocks)
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if default_deadline_s is not None and default_deadline_s <= 0:
            raise ValueError(f"default_deadline_s must be > 0, got {default_deadline_s}")
        if fault_retries < 0:
            raise ValueError(f"fault_retries must be >= 0, got {fault_retries}")
        if speculate < 0:
            raise ValueError(f"speculate must be >= 0, got {speculate}")
        if gauge_sweep_every_s < 0:
            raise ValueError(f"gauge_sweep_every_s must be >= 0, got {gauge_sweep_every_s}")
        if speculate and prefill_chunk is not None:
            raise ValueError(
                "speculate is incompatible with prefill_chunk (chunked admission "
                "interleaves decode steps; the speculative step replaces them)"
            )
        # the step-loop knobs, with the JAX server's checks and messages
        # (server.py:968-988); chunk_cycles is checked here too (the JAX
        # server takes 0, which dispatches empty chunks forever)
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if inflight_steps < 1:
            raise ValueError(f"inflight_steps must be >= 1, got {inflight_steps}")
        if chunk_cycles < 1:
            raise ValueError(f"chunk_cycles must be >= 1, got {chunk_cycles}")
        self.engine = engine
        self.cfg = engine.cfg
        #: the engine's executed stages, fixed for the server's life (a
        #: repartition builds a new server)
        self.model = engine.stages
        self.num_stages = len(self.model)
        #: the context-parallel degree: each stage's arena split by block
        #: over ``cp`` shards (``self.mesh``, ``cp × stages``)
        self.cp = int(cp)
        self.mesh = None
        cp_groups = None
        if self.cp > 1:
            self._check_cp(paged, tp, speculate, prefix_cache, prefill_chunk)
            from ..parallel.mesh import pipeline_cp_mesh

            # the engine's own devices: a replica of a ReplicatedServer
            # builds its grid from its own slice of the machine
            self.mesh = pipeline_cp_mesh(self.cp, self.num_stages, engine._devices)
            cp_groups = [tuple(self.mesh.devices[:, i]) for i in range(self.num_stages)]
        CP_SHARDS.set(float(self.cp))
        #: the tensor degree of every stage (its megatron shards)
        self.tp = tp
        self.capacity = int(capacity)
        self.batch_per_slot = int(batch_per_slot)
        #: M, the rows every program runs (JAX ``server.py:1307``)
        self.rows = self.num_stages * self.batch_per_slot
        #: decode steps per dispatched chunk
        self.chunk_cycles = int(chunk_cycles)
        #: logs the serial loop leaves in flight when a step returns
        self.pipeline_depth = int(pipeline_depth)
        #: decode dispatches the async executor keeps enqueued (1: the serial loop)
        self.inflight_steps = int(inflight_steps)
        # the defaults of requests that give no top_k / top_p
        self.top_k = int(top_k)
        self.top_p = validate_top_p(top_p)
        self.prefill_chunk = prefill_chunk
        #: paged arena (else dense per-row caches)
        self.paged = paged
        self.kv_block_size = int(kv_block_size) if paged else None
        self.kv_blocks = int(kv_blocks) if paged else None
        self.kv_dtype = kv_dtype
        self.speculate = int(speculate)
        self.spec_ngram = int(spec_ngram)
        # K + 1 columns over the usable capacity: a verify's entries past a
        # row's budget land there (paged: in trash block 0 through these
        # table entries; dense: in the row's own cache)
        self._spec_cols = self.speculate + 1 if self.speculate else 0
        #: the arena's storage dtype (engine.cache_dtype stays the compute dtype)
        self.kv_store_dtype = kv_storage_dtype(kv_dtype, engine.cache_dtype)
        #: the requested paged attention path (a snapshot keeps the request)
        self.paged_attn = paged_attn
        #: the paged attention backend every serve program runs
        self.attn_backend = (
            "kernel" if paged_attn != "plain" and engine.device.type == "cuda" else "plain"
        )
        if paged and self.attn_backend == "kernel" and not decode_block_size_ok(kv_block_size):
            raise ValueError(
                f"kv_block_size {kv_block_size}: the paged decode kernel takes 8, 16, 32 or a "
                "multiple of 64 (or serve with paged_attn='plain')"
            )
        self.max_queue = max_queue
        self.default_deadline_s = default_deadline_s
        self._fault_plan = fault_plan
        self._fault_retries = int(fault_retries)
        self._fault_backoff_s = float(fault_backoff_s)
        self._retryable = tuple(retryable_exceptions)
        self._health = SERVING
        self._step_contained = False  # a containment event this step
        self.containment_events = 0
        self.counters = Counters()
        # the block pool (None when dense: a row owns its cache). At cp > 1
        # it hands out GLOBAL ids over the shards (owner = gid // kv_blocks)
        # and stripes a row's blocks over them; the host mirror keeps the
        # global ids and _push_tables projects each shard's local plane
        self._alloc = None
        if paged:
            self._alloc = (
                ShardedBlockAllocator(self.cp, self.kv_blocks, self.kv_block_size)
                if self.cp > 1 else BlockAllocator(self.kv_blocks, self.kv_block_size)
            )
        # blocks pinned by live prefix handles: only release_prefix frees them
        self._handle_pins = 0
        self.state = serve_ops.make_state(
            self.cfg, self.rows, capacity=self.capacity + self._spec_cols,
            kv_blocks=self.kv_blocks or 0, kv_block_size=self.kv_block_size or 0,
            dtype=engine.cache_dtype, device=engine.device, kv_dtype=kv_dtype,
            stages=[(st.end - st.start, st.group or (st.device,)) for st in self.model],
            cp_groups=cp_groups,
        )
        # host mirror of the device block tables (dense: the placeholder;
        # cp > 1: global ids, one [M, T] for every shard's plane); pushed
        # before each dispatch that reads them once a release or a mapping
        # edited it
        self._tables = np.zeros(tuple(self.state.block_tables.shape[-2:]), np.int32)
        self._tables_dirty = False
        self._row_blocks: list[list[int]] = [[] for _ in range(self.rows)]  # private
        self._row_shared: list[list[int]] = [[] for _ in range(self.rows)]  # mapped read-only
        self._row_radix: list = [None] * self.rows  # each row's pinned RadixRef
        self._req: list[Optional[Request]] = [None] * self.rows
        self._admitting: set[int] = set()
        # the logs of dispatched programs not yet applied, oldest first
        self._pending: collections.deque[_InFlight] = collections.deque()
        # the generator marks of the program being dispatched (_push_pending)
        self._rng_marks_next: Optional[dict] = None
        # the newest program's entry while its landing is not yet charged
        # as device idle (None: the newest program returned no log)
        self._newest: Optional[_InFlight] = None
        self._stop_ids = frozenset(int(t) for t in self.cfg.eos_token_ids)
        self._queue: collections.deque[Request] = collections.deque()
        self._next_id = 0
        self._closed = False
        self._mutex = named_lock("server.mutex", "rlock")
        # the JSONL span file (None: spans reach only the flight recorder).
        # An observability knob, not serving state: snapshots leave it out
        self._trace = TraceWriter(trace_path) if trace_path else None
        self._span_src = "s0"
        #: the step profiler: one StepRecord per step
        self.stepline = StepProfiler(name="server")
        self.gauge_sweep_every_s = float(gauge_sweep_every_s)
        self._last_gauge_sweep = 0.0
        # a lower bound on the earliest live deadline (None: none armed);
        # the step's sweep scans only once it has passed
        self._deadline_hint: Optional[float] = None
        self._snapshot_every_s: Optional[float] = None
        self._snapshot_path: Optional[str] = None
        self._last_snapshot_at = time.perf_counter()
        if snapshot_every_s is not None or snapshot_path is not None:
            self.enable_auto_snapshot(snapshot_path, snapshot_every_s)
        # automatic prefix cache: the host tier defaults to an arena's worth
        # of blocks, the disk tier below it to another (server.py:1160-1175)
        self.prefix_cache = prefix_cache
        tiered = prefix_cache in ("host", "disk")
        self.host_pool_blocks = int(host_pool_blocks or self.kv_blocks or 0) if tiered else 0
        self.disk_pool_dir = disk_pool_dir if prefix_cache == "disk" else None
        self.disk_pool_blocks = (
            int(disk_pool_blocks or self.kv_blocks or 0) if prefix_cache == "disk" else 0
        )
        self._radix: Optional[RadixCache] = None
        if prefix_cache != "off":
            # the callbacks close over the state, not the server: a bound
            # method would make a server <-> tree cycle, and a dropped
            # server's arena would wait for the garbage collector
            # (cp > 1: through the server, whose block streams probe every
            # owner shard, by a weak reference for the same reason; the
            # demoted nodes carry their blocks' owner shards)
            read_kv = functools.partial(_read_arena_blocks, self.state)
            write_kv = functools.partial(_write_arena_blocks, self.state)
            if self.cp > 1:
                me = weakref.ref(self)
                read_kv = lambda blocks: me()._read_arena_blocks(blocks)  # noqa: E731
                write_kv = lambda blocks, *a: me()._write_arena_blocks(blocks, *a)  # noqa: E731
            self._radix = RadixCache(
                self._alloc, self.kv_block_size, host_pool_blocks=self.host_pool_blocks,
                read_kv=read_kv, write_kv=write_kv,
                block_owner=self._alloc.owner if self.cp > 1 else None,
                disk_pool_dir=self.disk_pool_dir, disk_pool_blocks=self.disk_pool_blocks,
            )
            if self.disk_pool_blocks:
                # the pool outlives the process: re-index what the last one left
                self._radix.adopt_pool()
        # registered last: the gauge sweep reads every field above
        _LIVE_SERVERS.add(self)
        _update_health_gauge()
        # the async executor's helper threads (none at depth 1: the serial
        # loop). A thread that cannot start raises here
        self._scheduler: Optional[_StepScheduler] = None
        self._sidecar: Optional[_CompletionSidecar] = None
        if self.inflight_steps > 1:
            self._scheduler = _StepScheduler(self)
            self._sidecar = _CompletionSidecar(self)
            self._scheduler.start()
            self._sidecar.start()
        INFLIGHT_STEPS.set(float(self.inflight_steps))

    def _check_cp(self, paged: bool, tp: int, speculate: int, prefix_cache: str,
                  prefill_chunk) -> None:
        """What context-parallel serving refuses, in the JAX server's words
        and order (``server.py:1231-1266``)."""
        if not paged:
            raise ValueError(
                "cp > 1 needs paged KV serving (set kv_block_size/"
                "kv_blocks): context-parallel serving shards the block "
                "arena — dense per-row reservations have no block dim "
                "to shard"
            )
        if tp > 1:
            raise NotImplementedError(
                "cp × tp serving: the cp arena sharding and megatron "
                "heads sharding both claim the KV leaves' trailing "
                "dims — pick one"
            )
        if self.cfg.model_type != "llama":
            raise NotImplementedError(
                "context-parallel serving supports the llama family "
                "only (the cross-shard softmax combine is threaded "
                "through the llama paged layer)"
            )
        if speculate:
            raise NotImplementedError(
                "cp > 1 with speculate: serve_verify's variable-length "
                "commits have no cross-shard combine yet — serve "
                "speculative on cp=1, or long-context on cp without "
                "speculation (ROADMAP: cp-aware speculation)"
            )
        if prefix_cache != "off" and prefill_chunk is None:
            raise ValueError(
                "cp > 1 with prefix_cache needs prefill_chunk: a radix "
                "hit's resident prefix spans multiple shards, so its "
                "suffix must prefill arena-native (chunked) — the "
                "one-shot gather path cannot assemble a cross-shard "
                "window"
            )

    # ---------------------------------------------------------------- API

    def submit(
        self,
        prompt_ids,
        max_new_tokens: int = 128,
        *,
        temperature: float = 0.0,
        seed: int = 0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        prefix: Optional[PrefixHandle] = None,
        deadline_s: Optional[float] = None,
        stop=None,
        trace: Optional[TraceContext] = None,
        tenant: Optional[str] = None,
    ) -> Request:
        """Enqueue a request; it is admitted by a later ``step``. Raises
        ``NeverFits`` for a request no amount of waiting could admit,
        ``QueueFull`` when ``max_queue`` requests wait and ``ServerClosed``
        after ``close``. With ``prefix`` (a handle of this server's
        ``prefill_prefix``) ``prompt_ids`` is the suffix only: generation
        equals submitting ``prefix + suffix`` whole, and the admission is
        one-shot. ``deadline_s`` (default ``default_deadline_s``) bounds the
        request's life from now: past it the request fails with
        ``DeadlineExceeded``. ``stop`` (strings; the engine needs a
        ``tokenizer``) finishes the request once its decoded text holds one
        of them, the tokens cut to the shortest prefix that does. ``trace``
        (a caller's ``TraceContext``) parents the request's spans; without
        it the request starts a trace of its own. ``top_k`` / ``top_p``
        default to the server's. ``tenant`` (the ingress's) rides on the
        request into its ``request`` span."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        top_k, top_p = self._resolve_filters(top_k, top_p)
        deadline_s = self._resolve_deadline(deadline_s)
        bucket, chunked, spx = self._plan_request(prompt, max_new_tokens, prefix)
        stop = self._validate_stop(stop)
        with self._mutex:
            self._check_admission()
            self._check_never_fits(bucket, max_new_tokens, spx, chunked)
            req = Request(self._new_id(), prompt, int(max_new_tokens), float(temperature),
                          int(seed), top_k, top_p, prefix, deadline_s, stop, trace,
                          tenant=tenant)
            return self._enqueue(req)

    def submit_embedding(
        self,
        prompt_embeds,  # [S, H] (or [1, S, H]) hidden states
        max_new_tokens: int = 128,
        *,
        temperature: float = 0.0,
        seed: int = 0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        stop=None,
        deadline_s: Optional[float] = None,
        tenant: Optional[str] = None,
        trace: Optional[TraceContext] = None,
    ) -> Request:
        """Enqueue a request that enters as embeddings, the privacy entry
        (``server.py:2128``): the caller embeds its ids (``Engine.embed_prompt``)
        and only hidden states reach the server, so ``submit_embedding(
        engine.embed_prompt(ids)[0], ...)`` generates what ``submit(ids,
        ...)`` does. The states are cast to the engine's dtype. Such a
        request always admits one-shot (chunked prefill is an ids-path
        optimization), dense or paged."""
        top_k, top_p = self._resolve_filters(top_k, top_p)
        deadline_s = self._resolve_deadline(deadline_s)
        h = _as_embeds(prompt_embeds, self.engine.cache_dtype)
        if h.ndim == 3:
            if h.shape[0] != 1:
                raise ValueError(
                    f"submit_embedding takes one request: got batch {h.shape[0]} "
                    "(submit each row separately)"
                )
            h = h[0]
        if h.ndim != 2 or h.shape[1] != self.cfg.hidden_size:
            raise ValueError(
                f"prompt_embeds must be [S, {self.cfg.hidden_size}], got {tuple(h.shape)}"
            )
        bucket = self._plan_request(h, max_new_tokens, None, chunkable=False)[0]
        stop = self._validate_stop(stop)
        with self._mutex:
            self._check_admission()
            self._check_never_fits(bucket, max_new_tokens, 0, False)
            req = Request(self._new_id(), np.zeros((0,), np.int32), int(max_new_tokens),
                          float(temperature), int(seed), top_k, top_p, None, deadline_s, stop,
                          trace, embeds=h, tenant=tenant)
            return self._enqueue(req)

    def _enqueue(self, req: Request) -> Request:
        """A validated request joins the queue (mutex held)."""
        if self.speculate:
            req.spec_k = AdaptiveK(self.speculate)
        self._queue.append(req)
        self._arm_deadline(req.deadline_at)
        self.counters.inc("requests_submitted")
        _update_load_gauges()
        return req

    def prefill_prefix(self, prefix_ids) -> PrefixHandle:
        """Prefill a shared prefix once (``server.py:1637``) and return its
        handle. The prefix is padded to an admission bucket, at least one
        block, so its blocks are exactly the table entries ``[0, spx /
        block_size)``; suffix positions resume at its real length ``n``."""
        if self.cp > 1:
            raise NotImplementedError(
                "prefill_prefix does not support context-parallel serving "
                "(cp > 1): an explicit PrefixHandle seeds whole-prefix KV "
                "into admission, which would need per-shard window gathers "
                "across the cp-sharded arena. Use prefix_cache='hbm' (the "
                "radix tree admits hits through the cp-aware chunked path) "
                "or serve with cp=1."
            )
        prefix = np.asarray(prefix_ids, np.int32).reshape(-1)
        n = int(prefix.shape[0])
        if n < 1:
            raise ValueError("prefix must be non-empty")
        spx = self._bucket(n)
        if self.paged:  # block-aligned: the shared blocks are table entries [0, spx / BS)
            spx = max(spx, self.kv_block_size)
        if spx + 1 > self.capacity:
            raise ValueError(f"prefix bucket ({spx}) exceeds server capacity ({self.capacity})")
        buf = np.zeros((1, spx), np.int32)
        buf[0, :n] = prefix
        with self._mutex:
            if self._closed:
                raise ServerClosed("server is closed; prefill_prefix rejected")
            kv = serve_ops.prefix_prefill(
                self.cfg, self.model, buf, n, self.engine.cache_dtype, self.engine.device
            )
            if not self.paged:  # a dense handle owns no blocks
                logger.info("prefill_prefix n=%d bucket=%d blocks=-", n, spx)
                return PrefixHandle(kv, n, spx)
            need = spx // self.kv_block_size
            if self._radix is not None and need > self._alloc.num_free:
                # cold cached prefixes make way for an explicit, pinned handle
                self._radix.ensure_free(need)
            blocks = self._alloc.alloc(need)
            self._handle_pins += len(blocks)
            _update_load_gauges()
        logger.info("prefill_prefix n=%d bucket=%d blocks=%d", n, spx, len(blocks))
        return PrefixHandle(kv, n, spx, blocks, self)

    def release_prefix(self, handle: PrefixHandle) -> None:
        """Drop a handle's own block references (``server.py:3317``). Rows
        still mapping the blocks keep them until they finish; a double
        release is a no-op; a handle of another server is refused."""
        with self._mutex:
            if handle.blocks and not handle.owned_by(self):
                raise ValueError(
                    "prefix handle belongs to a different server — release_prefix on "
                    "the server that prefilled it"
                )
            blocks, handle.blocks = handle.blocks, None
            if blocks:
                self._handle_pins -= len(blocks)
                self._alloc.free(blocks)

    def radix_match_tokens(self, prompt_ids) -> int:
        """How many leading tokens of ``prompt_ids`` the prefix cache holds
        (0 with the cache off)."""
        if self._radix is None:
            return 0
        with self._mutex:
            return self._radix.match_tokens(np.asarray(prompt_ids, np.int32).reshape(-1))

    def prefix_cache_stats(self) -> Optional[dict]:
        """The tree's hit and tier counters (``RadixCache.stats``); None with
        the cache off."""
        if self._radix is None:
            return None
        with self._mutex:
            return self._radix.stats()

    def step(self) -> bool:
        """Shed expired requests, admit what fits, dispatch one decode chunk
        over every row (or, with ``speculate``, one verify), then apply
        logs down to the loop's depth and take the queue head's radix match
        ahead of its admission; with auto-snapshot armed, end by
        checkpointing once per interval. A failure is contained to the
        requests it touched and the server keeps stepping; a clean step
        after one restores SERVING. A closed server does nothing. Returns
        True if any work was done.

        The serial loop (``inflight_steps=1``, ``_step_serial``) leaves the
        newest ``pipeline_depth`` logs in flight, so tokens surface that
        many steps late and ``run_until_idle`` drains the tail; with
        ``inflight_steps`` > 1 the async executor's body (``_step_async``)
        runs instead. Greedy output is token-identical at every depth. The
        step is one ``StepRecord`` of ``self.stepline`` (phases as in JAX
        ``server.py:2240-2461``)."""
        if self.inflight_steps > 1:
            return self._step_async()
        return self._step_serial()

    def _step_serial(self) -> bool:
        """The single-threaded step body (``server.py:2240-2336``): it
        drains AFTER its dispatch, down to ``pipeline_depth``, and sweeps
        the gauges and stages the radix plan itself."""
        with self._mutex:
            if self._closed:
                return False
            sl = self.stepline
            tok0 = self._begin_boundary()
            self._step_contained = False
            sl.push("admit")
            progressed = self._shed_expired()
            progressed |= self._admit_if_free()
            sl.pop()
            if self.speculate and self._any_active():
                progressed = True
                applied, dt_apply = self._spec_boundary(None)
            elif self._any_active():
                self._dispatch_chunk()
                progressed = True
                applied, dt_apply = self._timed_drain(self.pipeline_depth, None)
            else:
                applied, dt_apply = self._timed_drain(0, None)
            if progressed or applied:
                self._report_apply(dt_apply, applied)
                now = time.perf_counter()
                if (self.gauge_sweep_every_s <= 0.0
                        or now - self._last_gauge_sweep >= self.gauge_sweep_every_s):
                    sl.push("gauge_sweep")
                    _update_load_gauges()
                    sl.pop()
                    self._last_gauge_sweep = now
            if self._radix is not None and self._queue:
                # after this step's dispatch: a host-tier restore it starts
                # queues behind the chunk in flight
                sl.push("radix_plan")
                self._stage_radix_plan()
                sl.pop()
            snap_due = self._end_boundary(progressed, applied, tok0)
        # the file write runs outside the mutex: consumers on other threads
        # stay live while it lands
        if snap_due is not None:
            self._write_autosnapshot(snap_due)
        return progressed

    def _step_async(self) -> bool:
        """The async executor's body (``inflight_steps`` > 1,
        ``server.py:2338-2461``): apply the scheduler's published delta
        (``publish``; the inline sweep when none is published), admit,
        drain inline only as far as the window of ``inflight_steps``
        dispatches requires (``drain``, with ``fetch`` / ``apply`` nested),
        THEN dispatch. The gauge sweep and the radix staging run on the
        scheduler, whose overlapped ``plan`` time reaches the phase
        histogram off-thread and never a StepRecord. The step ends by
        kicking the scheduler and waking the sidecar, under the mutex
        (their conditions rank after it). A helper thread that died makes
        the step raise its exception."""
        sched, sidecar = self._scheduler, self._sidecar
        with self._mutex:
            if self._closed:
                return False
            self._check_helpers()
            sl = self.stepline
            tok0 = self._begin_boundary()
            # _step_contained is not reset here: a containment the sidecar
            # made between steps suppresses this step's recovery, as an
            # in-step one would
            sl.push("publish")
            delta = sched.take() if sched is not None else None
            if delta is not None:
                progressed = self._apply_delta(delta)
                if self._deadline_hint is not None and time.perf_counter() >= self._deadline_hint:
                    # a deadline passed after the delta was planned: sweep
                    # inline so the expiry lands at this boundary
                    progressed |= self._shed_expired()
            else:
                progressed = self._shed_expired()
            sl.pop()
            sl.push("admit")
            progressed |= self._admit_if_free()
            sl.pop()
            if self.speculate and self._any_active():
                progressed = True
                applied, dt_apply = self._spec_boundary("drain")
            elif self._any_active():
                # backpressure BEFORE the dispatch: at most inflight_steps - 1
                # unapplied logs, so the dispatch below fills the window
                applied, dt_apply = self._timed_drain(self.inflight_steps - 1, "drain")
                self._dispatch_chunk()
                progressed = True
            else:
                applied, dt_apply = self._timed_drain(0, "drain")
            if progressed or applied:
                self._report_apply(dt_apply, applied)
            snap_due = self._end_boundary(progressed, applied, tok0)
            self._step_contained = False  # consumed: the next boundary may recover
            if sched is not None:
                sched.kick()
            if sidecar is not None and self._pending:
                sidecar.notify()
        if snap_due is not None:
            self._write_autosnapshot(snap_due)
        return progressed

    # -- the parts both step bodies share (mutex held) ----------------------

    def _check_helpers(self) -> None:
        """Raise the exception a helper thread of the async executor died
        of (at every step from then on: the server cannot keep its
        threaded contract without it)."""
        for t in (self._scheduler, self._sidecar):
            if t is not None and t.error is not None:
                raise RuntimeError(
                    f"the async executor's {t.name} thread failed: {t.error!r}"
                ) from t.error

    def _begin_boundary(self) -> int:
        """Open the step's record; the tokens generated so far."""
        self.stepline.begin_step()
        return self.counters.tokens_generated

    def _admit_if_free(self) -> bool:
        """Admit from the queue when the mirror shows a free row. Admission
        needs current mirrors, so every log is applied first; gated on the
        free row so a full server does not wait on its newest chunk every
        step (a row freed inside an unapplied log is seen one step later)."""
        if not (self._queue and self._free_rows()):
            return False
        self._drain(0)
        return self._admit_pending()

    def _timed_drain(self, max_pending: int, phase: Optional[str]) -> Tuple[int, float]:
        """``_drain(max_pending)``, inside ``phase`` when given; the entries
        applied and the seconds it took."""
        sl = self.stepline
        t0 = time.perf_counter()
        if phase:
            sl.push(phase)
        applied = self._drain(max_pending)
        if phase:
            sl.pop()
        return applied, time.perf_counter() - t0

    def _spec_boundary(self, phase: Optional[str]) -> Tuple[int, float]:
        """One verify, then every log applied: speculation keeps an
        effective depth of 1 at every setting, since the next drafts need
        this verify's commits (``server.py:2393-2404``)."""
        sl = self.stepline
        sl.push("dispatch")
        self._spec_step()
        sl.pop()
        return self._timed_drain(0, phase)

    def _report_apply(self, dt_apply: float, applied: int) -> None:
        """The ``apply`` span; writing it is host work of the apply it
        reports on."""
        sl = self.stepline
        sl.push("apply")
        self._span("apply", dur_s=dt_apply, applied=applied)
        sl.pop()

    def _end_boundary(self, progressed: bool, applied: int, tok0: int):
        """Capture a due auto-snapshot, restore SERVING after a clean step,
        close the step's record. Returns the snapshot to write outside the
        mutex, or None."""
        snap_due = self._capture_autosnapshot()
        if (
            self._health == DEGRADED and not self._step_contained
            # idle counts as clean: nothing is left to fail
            and (progressed or applied
                 or not (self._queue or self._any_active() or self._pending))
        ):
            self._set_health(SERVING)
        self.stepline.end_step(
            rows=sum(1 for r in self._req if r is not None and not r.done),
            tokens=self.counters.tokens_generated - tok0, queued=len(self._queue),
            pending=len(self._pending),
        )
        return snap_due

    def run_until_idle(self) -> None:
        while not self._closed and (self._queue or self._any_active() or self._pending):
            self.step()

    def stream(self, req: Request) -> Iterator[int]:
        """Yield ``req``'s tokens as they are produced, pumping the server.
        A failed request raises ``RequestFailed`` (its cause chained) after
        its partial tokens; so does a request this server can no longer
        advance (idle or closed with the request unfinished)."""
        idx = 0
        while True:
            with self._mutex:
                batch, done, error = req.tokens[idx:], req.done, req.error
            yield from batch
            idx += len(batch)
            if done:
                if error is not None:
                    raise RequestFailed(f"request {req.id} failed: {error}", req) from error
                return
            if not self.step() and not req.done and not (
                self._queue or self._any_active() or self._pending
            ):
                raise RequestFailed(
                    f"request {req.id} cannot finish here: the server is idle or closed", req
                )

    def result(self, req: Request) -> list:
        """Pump until ``req`` finishes; its generated token ids."""
        return list(self.stream(req))

    def stepline_stats(self, last_n: int = 64) -> dict:
        """Step-profiler aggregates over the ring tail (``server.py:2607``):
        host occupancy, device-idle fraction, p50 step wall."""
        return self.stepline.stats(last_n)

    def stepline_snapshot(self, last_n: Optional[int] = None) -> list:
        """The step ring's records oldest-first (JSON-ready dicts)."""
        return self.stepline.snapshot(last_n)

    def stepline_capture(self, steps: int, wait_s: float = 5.0,
                         trace_dir: Optional[str] = None) -> dict:
        """Arm an N-step deep capture (full sub-phase timeline, lock-wait
        deltas, applied-row trace_id exemplars) and wait up to ``wait_s``
        for the step pump to fill it (``server.py:2617``); the bundle says
        ``complete: false`` if the loop idled first. The wait holds no
        lock: call it from another thread while the pump steps (or arm
        ``self.stepline`` and drive ``step`` yourself).

        With ``trace_dir``, ``torch.profiler`` brackets the window and its
        Chrome trace is written there (``device_trace`` in the bundle):
        host and CUDA activity on a CUDA server, host activity on a CPU
        one. On the card a trace that recorded no device activity while
        the window dispatched programs raises: there is no host-only
        fallback."""
        if not trace_dir:
            return self.stepline.capture(steps, wait_s)
        cuda = self.engine.device.type == "cuda"
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        try:
            bundle = self.stepline.capture(steps, wait_s)
        finally:
            prof.stop()
        dispatched = any("dispatch" in s["phases"] for s in bundle["steps"])
        if cuda and dispatched and not any(
            str(e.device_type).endswith("CUDA") for e in prof.events()
        ):
            raise RuntimeError(
                "stepline_capture: torch.profiler recorded no CUDA activity while the "
                "captured steps dispatched programs (CUPTI unavailable?)"
            )
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"stepline_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        bundle["device_trace"] = path
        bundle["device_trace_dir"] = trace_dir
        return bundle

    def cancel(self, req: Request) -> bool:
        """Cancel a queued or in-flight request; True if it was live here. A
        live row's prompt KV is complete, so its blocks go into the prefix
        cache as on a clean finish."""
        with self._mutex:
            if req.done:
                return False
            if req.row is None:
                try:
                    self._queue.remove(req)
                except ValueError:
                    return False
                self._release_staged(req)
            else:
                if self._req[req.row] is not req:
                    return False
                serve_ops.serve_cancel_rows(self.state, [req.row])
                self._release(req.row, insert=True)
            req.done = True
            req.finished_at = time.perf_counter()
            self.counters.inc("requests_cancelled")
            emit_span(
                self._trace, "request", dur_s=req.finished_at - req.submitted_at,
                trace=req.trace, src=self._span_src, id=req.id, tokens=len(req.tokens),
                outcome="cancelled", **_tenant_field(req),
            )
            _update_load_gauges()
            return True

    def close(self) -> None:
        """Shut down (``server.py:2711``), idempotent: reject submits, fail
        every queued and in-flight request with ``ServerClosed`` (a
        ``stream`` on another thread then raises ``RequestFailed``), free
        their blocks (not cached) and go DRAINING; ``step`` does nothing
        after; the async executor's threads are stopped and joined."""
        with self._mutex:
            if self._closed:
                return
            self._closed = True
            err = ServerClosed("server closed")
            for r in list(self._queue):
                self._fail_request(r, err)
            self._queue.clear()
            victims = [r for r in self._req if r is not None and not r.done]
            if victims:
                serve_ops.serve_cancel_rows(self.state, [r.row for r in victims])
                for r in victims:
                    self._fail_request(r, err)
            self._admitting.clear()
            self._pending.clear()
            self._set_health(DRAINING)
            _update_load_gauges()
            if self._trace is not None:
                self._trace.close()
        # the helper threads: signalled outside the mutex (their loops check
        # _closed under it) and joined
        for t in (self._scheduler, self._sidecar):
            if t is not None:
                t.stop()
                t.join(timeout=5.0)
        logger.info("server closed")

    @property
    def health(self) -> str:
        """``SERVING``, ``DEGRADED`` (a failure was contained: some requests
        failed, the rest are served; clears on the next clean step) or
        ``DRAINING`` (closed)."""
        return self._health

    def arena_bytes(self) -> int:
        """Device bytes of the KV arena and its scale pools (dense: of the
        per-row caches)."""
        if self._alloc is None:
            return sum(2 * a.k.numel() * a.k.element_size() for a in self.state.arenas)
        return self._alloc.arena_bytes(
            num_layers=self.cfg.num_hidden_layers, num_kv_heads=self.cfg.num_key_value_heads,
            head_dim=self.cfg.head_dim_, kv_dtype=self.kv_store_dtype,
        )

    def enable_auto_snapshot(self, path: Optional[str], every_s: Optional[float]) -> None:
        """Arm (or, with two Nones, disarm) periodic crash-recovery
        checkpoints (``server.py:2664``): at most one atomic
        ``save_snapshot`` to ``path`` per ``every_s`` seconds, taken at the
        end of ``step`` (0: every step). Not serving state: a restored
        server is armed again by its caller."""
        if (path is None) != (every_s is None):
            raise ValueError(
                "snapshot_path and snapshot_every_s go together (got "
                f"path={path!r}, every_s={every_s!r})"
            )
        if every_s is not None and every_s < 0:
            raise ValueError(f"snapshot_every_s must be >= 0, got {every_s}")
        self._snapshot_path = path
        self._snapshot_every_s = every_s
        self._last_snapshot_at = time.perf_counter()

    # -------------------------------------------------- snapshot / restore

    def snapshot(self) -> dict:
        """Checkpoint the live server between steps (``server.py:1710``):
        the arena blocks that rows and the tree hold (codes and scales; a
        free block's bytes are never read, so they are not kept), the
        rows' key positions, block tables and host bookkeeping (a dense
        server: the caches of the rows that hold a request), each
        sampled row's generator state, block ownership, the prefix tree
        (disk-tier nodes as references to their pool entries), the
        requests in rows and queue (deadlines as time remaining), the next
        request id (read, not consumed), the counters and the serve
        options (``paged_attn`` as requested). It applies every log in
        flight first (``server.py:1740``), so it is taken at a settled
        boundary. ``restore`` continues every request token-identically.

        Refused on a closed server, mid-chunked-admission and while queued
        requests hold prefix handles (their KV is bound to this process: let
        them admit, or resubmit them after restore)."""
        with self._mutex:
            if self._closed:
                raise ServerClosed("cannot snapshot a closed server")
            if self._admitting:
                raise RuntimeError(
                    "snapshot mid-chunked-admission is not supported — call between steps"
                )
            if any(r.prefix is not None for r in self._queue):
                raise ValueError(
                    "queued requests hold prefix handles (device-bound KV); pump until "
                    "they admit or resubmit after restore"
                )
            self._drain(0)  # the mirrors and the requests are current
            self._flush_tables()
            st = self.state
            rsnap = None if self._radix is None else self._radix.snapshot()
            if self.paged:
                held = set()
                for b in self._row_blocks + self._row_shared:
                    held.update(b)
                if rsnap is not None:
                    for m in rsnap["nodes"]:
                        if m["tier"] == "hbm":
                            held.update(m["blocks"])
                arena = self._capture_arena(sorted(held))
                paged = {
                    "tables": self._tables.copy(),
                    "row_blocks": [list(map(int, b)) for b in self._row_blocks],
                    "row_shared": [list(map(int, b)) for b in self._row_shared],
                }
            else:
                arena = self._capture_rows([i for i, r in enumerate(self._req) if r is not None])
                paged = None
            return {
                "format": SNAPSHOT_FORMAT,
                "serve_kwargs": dict(
                    capacity=self.capacity, batch_per_slot=self.batch_per_slot,
                    chunk_cycles=self.chunk_cycles, top_k=self.top_k, top_p=self.top_p,
                    pipeline_depth=self.pipeline_depth, inflight_steps=self.inflight_steps,
                    prefill_chunk=self.prefill_chunk, kv_block_size=self.kv_block_size,
                    kv_blocks=self.kv_blocks, kv_dtype=self.kv_dtype,
                    paged_attn=self.paged_attn, prefix_cache=self.prefix_cache,
                    host_pool_blocks=self.host_pool_blocks, disk_pool_dir=self.disk_pool_dir,
                    disk_pool_blocks=self.disk_pool_blocks, max_queue=self.max_queue,
                    default_deadline_s=self.default_deadline_s,
                    speculate=self.speculate, spec_ngram=self.spec_ngram,
                    # the shard count: restore refuses a grid it cannot
                    # build rather than reshard (JAX server.py:1845-1848)
                    cp=self.cp,
                ),
                "arena_dtype": str(self.kv_store_dtype),
                "num_stages": self.num_stages,
                "tensor_parallel": self.tp,
                "rng_device": self.engine.device.type,
                "arena": arena,
                "state": dict(
                    {k: serve_ops._raw(getattr(st, k)) for k in _DEVICE_ROW_STATE},
                    kpos=serve_ops._raw(st.kpos), out=st.out.copy(), temp=st.temp.copy(),
                    topk=st.topk.copy(), topp=st.topp.copy(),
                ),
                "paged": paged,
                "radix": rsnap,
                "rows": [self._req_dict(r) for r in self._req],
                "queue": [self._req_dict(r) for r in self._queue],
                "next_id": self._next_id,
                "counters": self.counters.snapshot(),
            }

    @classmethod
    def restore(cls, engine, snap: dict) -> "PipelineServer":
        """A fresh server over ``engine`` (the same model and device type)
        that continues ``snap``'s requests (``server.py:1874``). The server
        is built through ``engine.serve`` with the snapshot's options, so
        restore runs the ordinary constructor's validation; the held blocks
        are then copied into its (only) arena in chunks. A tree in the
        snapshot restored with the cache off is dropped: the rows sharing
        its blocks own them and free them on finish. A snapshot without the
        step-loop options (``chunk_cycles``, ``pipeline_depth``,
        ``inflight_steps``, ``top_k``, ``top_p``) or without ``cp``
        restores with their defaults."""
        if snap.get("format") != SNAPSHOT_FORMAT:
            raise ValueError(
                f"unknown snapshot format {snap.get('format')!r} (this package writes "
                f"{SNAPSHOT_FORMAT}; it does not read the JAX package's snapshots)"
            )
        if engine.tokenizer is None and any(
            d is not None and d.get("stop") for d in snap["rows"] + snap["queue"]
        ):
            # every committed token of such a request decodes its text
            raise ValueError(
                "snapshot carries requests with stop strings but the engine has no tokenizer"
            )
        # dense and paged are different device layouts (server.py:1911-1925)
        paged = snap["serve_kwargs"].get("kv_block_size") is not None
        if paged and not snap.get("paged"):
            raise ValueError(
                "dense-mode snapshot cannot restore into a paged server (no block "
                "ownership recorded): restore without kv_block_size/kv_blocks, or "
                "re-serve and let requests re-admit"
            )
        if not paged and snap.get("paged"):
            raise ValueError(
                "paged-mode snapshot cannot restore into a dense server: keep the "
                "snapshot's kv_block_size/kv_blocks serve kwargs"
            )
        stages = int(snap.get("num_stages", 1))
        if stages != engine.num_stages:
            raise ValueError(
                f"snapshot was taken over {stages} stage(s), engine placement runs "
                f"{engine.num_stages} — restore needs the same stages/capacity/"
                "batch_per_slot the snapshot was taken with"
            )
        tp = int(snap.get("tensor_parallel", 1))
        if tp != engine.tensor_parallel:
            raise ValueError(
                f"snapshot was taken at tensor_parallel={tp}, engine runs "
                f"{engine.tensor_parallel} — restore needs the tensor degree the "
                "snapshot was taken with (extract/adopt moves requests across degrees)"
            )
        cp = int(snap["serve_kwargs"].get("cp", 1) or 1)
        if cp > 1:
            # the arena was captured over cp shards: a restore onto fewer
            # would need a resharding pass (JAX server.py:1891-1909)
            have = len(engine._devices)
            if cp * stages > have:
                raise ValueError(
                    f"snapshot was taken at cp={cp} but the restoring "
                    f"engine has {have} device(s) for {stages} pipeline "
                    f"stage(s) — a context-parallel restore needs "
                    f"cp×stages={cp * stages} devices on the same "
                    "topology. Restore on a matching mesh, or move the "
                    "live requests instead: extract/adopt re-admits them "
                    "on a survivor of any cp."
                )
        srv = engine.serve(**snap["serve_kwargs"])
        st = srv.state
        if snap["arena_dtype"] != str(srv.kv_store_dtype):
            raise ValueError(
                f"snapshot arena stores {snap['arena_dtype']}, this server's arena "
                f"{srv.kv_store_dtype} — restore on an engine of the snapshot's dtype"
            )
        host = snap["state"]
        want = {"kpos": tuple(st.kpos.shape)}
        want.update({k: getattr(st, k).shape for k in host if k != "kpos"})
        got = {k: np.shape(v) for k, v in host.items()}
        if paged:
            want["tables"] = srv._tables.shape
            got["tables"] = np.shape(snap["paged"]["tables"])
        for name, shape in want.items():
            if tuple(got.get(name, ())) != tuple(shape):
                raise ValueError(
                    f"snapshot state {name!r} has shape {got.get(name)}, this server "
                    f"expects {tuple(shape)} — restore needs the model and options the "
                    "snapshot was taken with"
                )
        sampled = [d for d in snap["rows"] + snap["queue"]
                   if d is not None and (d.get("rng") is not None
                                         or d.get("carried_rng") is not None)]
        if sampled and snap["rng_device"] != engine.device.type:
            raise ValueError(
                f"snapshot's sampled requests carry {snap['rng_device']} generator states; "
                f"this engine is on {engine.device.type}: restore on a "
                f"{snap['rng_device']} device"
            )
        if paged:
            srv._restore_arena(snap["arena"])
        else:
            srv._restore_rows(snap["arena"])
        st.kpos.copy_(torch.from_numpy(np.asarray(host["kpos"], np.int32)))
        for k, v in host.items():
            if k in _DEVICE_ROW_STATE:
                dst = getattr(st, k)
                dst.copy_(torch.from_numpy(np.asarray(v)).to(dst.dtype))
            elif k != "kpos":
                np.copyto(getattr(st, k), v)
        # taken at a settled boundary: the mirrors equal the device's rows
        st.mirror_len[:] = np.asarray(host["lengths"], np.int64)
        st.mirror_budget[:] = np.asarray(host["budget"], np.int64)
        rsnap = snap.get("radix")
        if paged:
            # global ids at cp > 1: the push re-projects every shard's plane
            srv._tables[:] = np.asarray(snap["paged"]["tables"], np.int32)
            srv._push_tables()
            srv._row_blocks = [[int(x) for x in b] for b in snap["paged"]["row_blocks"]]
            srv._row_shared = [[int(x) for x in b] for b in snap["paged"]["row_shared"]]
            tree_owned = []
            if srv._radix is not None and rsnap is not None:
                tree_owned = [m["blocks"] for m in rsnap["nodes"] if m["tier"] == "hbm"]
            elif rsnap is not None:
                logger.warning(
                    "snapshot carries a prefix-cache tree but this server has "
                    "prefix_cache=off — dropping the cache (row-shared blocks free as "
                    "their rows finish)"
                )
            srv._alloc.restore(srv._row_blocks + tree_owned, srv._row_shared)
        if srv._radix is not None and rsnap is not None:
            srv._radix.restore(rsnap, rsnap["arrays"])
        now = time.perf_counter()
        for d in snap["rows"]:
            if d is None:
                continue
            r = srv._req_from(d, now)
            srv._req[r.row] = r
            if d.get("rng") is not None:
                g = torch.Generator(device=engine.device)
                g.set_state(torch.from_numpy(np.asarray(d["rng"], np.uint8)))
                st.rng[r.row] = g
            rn = int(d.get("radix_n") or 0)
            if rn and srv._radix is not None:
                # pins are live state: every pinned path survived (pinned
                # nodes are never evicted), so the row takes its match again
                ref = srv._radix.take(r.prompt[:rn], rn)
                if ref is not None and ref.n == rn:
                    srv._row_radix[r.row] = ref
                elif ref is not None:
                    srv._radix.release(ref)
        srv._queue = collections.deque(srv._req_from(d, now) for d in snap["queue"])
        for r in list(srv._queue) + [r for r in srv._req if r is not None]:
            srv._arm_deadline(r.deadline_at)
        srv._next_id = int(snap["next_id"])
        srv.counters = Counters.from_snapshot(snap["counters"])
        _update_load_gauges()
        return srv

    # ------------------------------------------------------------ migration

    def extract(self, req: Request, *, settle: Optional[bool] = None) -> RequestState:
        """Take a live request off this server as portable host-side state
        without failing it (``server.py:3338``): it leaves the queue or its
        row (the row's prompt blocks go into the prefix cache, as on a
        cancel), and the caller re-admits it elsewhere with ``adopt``. The
        request object is untouched but for ``row``, so a ``stream`` over it
        carries on. The resumed prompt is the applied tokens, the sampling
        state the row generator's host-side state.

        ``settle`` applies every log in flight first (``_drain(0)``), so the
        state carries every token the device computed. ``None`` (the
        default) settles whenever logs are pending on an open server, at
        every depth: unlike the JAX server, whose sampling chain is
        recomputed from the applied tokens, a row's ``torch.Generator``
        advances when a program is launched, and an unsettled extract of a
        sampled row would carry draws of steps whose tokens it drops (the
        continuation is then another seeded stream). ``settle=False`` skips
        it (a replica that cannot read its logs): the tokens in flight are
        regenerated by the adopter, and a sampled row carries its generator
        state from before the oldest draw in flight (recorded at each
        launch), so the adopter redraws them as this server drew them.
        Refuses a finished request and one this server does not hold."""
        with self._mutex:
            if settle is None:
                settle = not self._closed
            if settle and self._pending and not req.done:
                self._drain(0)
            if req.done:
                raise ValueError(f"request {req.id} is finished; nothing to extract")
            rng = req.carried_rng
            if req.row is None:
                try:
                    self._queue.remove(req)
                except ValueError:
                    raise ValueError(f"request {req.id} is not held by this server") from None
                self._release_staged(req)
            else:
                row = req.row
                if self._req[row] is not req:
                    raise ValueError(f"request {req.id} is not held by this server")
                if row in self._admitting:
                    raise RuntimeError(
                        f"request {req.id} is mid-chunked-admission; extract between steps"
                    )
                gen = self.state.rng[row]
                rng = None if gen is None else gen.get_state().numpy().copy()
                # unsettled: the tokens in flight are dropped, so the state
                # to carry is the one before the oldest pending draw
                mark = next((e.rng_marks for e in self._pending
                             if e.rng_marks and row in e.rng_marks), None)
                if mark is not None:
                    st = mark[row]
                    rng = None if st is None else np.asarray(st, np.uint8).copy()
                serve_ops.serve_cancel_rows(self.state, [row])
                self._release(row, insert=True)
            tail = np.asarray(req.tokens[req.baked:], np.int32)
            remaining = int(req.max_new) - int(tail.shape[0])
            if req.embeds is not None:  # the adopter embeds the tail itself
                prompt = np.zeros((0,), np.int32)
            else:
                prompt = np.concatenate([np.asarray(req.prompt, np.int32), tail])
            self._span("extract", req=req, tokens=len(req.tokens), remaining=remaining)
            _update_load_gauges()
        logger.info("extract id=%d tokens=%d remaining=%d rng=%s",
                    req.id, len(req.tokens), remaining, rng is not None)
        return RequestState(
            prompt=prompt, tail=tail, remaining=remaining, rng=rng,
            rng_device=None if rng is None else self.engine.device.type, prefix=req.prefix,
            stop=tuple(req.stop), trace=req.trace, embeds=req.embeds, tenant=req.tenant,
        )

    def adopt(self, state: RequestState, req: Request, *,
              prefix: Optional[PrefixHandle] = None, front: bool = True) -> None:
        """Re-admit an ``extract``ed request here (``server.py:3458``), the
        same ``Request`` object (taking the state's trace context, so its
        spans join one tree): its resumed prompt goes through the
        ordinary admission (one-shot or chunked, by its bucket), new tokens
        append to the same ``tokens`` list, and a carried generator state
        is installed at admission, so a sampled row resumes its draws.
        ``prefix`` is this server's handle for a request submitted with one.
        With ``front`` (the default) it is queued ahead of fresh
        submissions (it is the oldest work), else behind them
        (``server.py:3572``); ``max_queue`` does not gate it (it moves
        load, adds none).

        Raises ``ServerClosed`` on a closed server, ``ValueError`` (or its
        ``NeverFits``) for a finished request, a resumed prompt that does
        not fit this server, a missing handle, or a sampled request's
        generator of another device type; every check runs before any
        change, so a refused request stays adoptable elsewhere."""
        with self._mutex:
            if self._closed:
                _M_REJECTED.labels(reason="closed").inc()
                raise ServerClosed("server is closed; adopt rejected")
            if req.done:
                raise ValueError(f"request {req.id} is already finished")
            stop = tuple(state.stop)
            if stop and self.engine.tokenizer is None:
                raise ValueError(
                    "request carries stop strings but this server's engine has no tokenizer"
                )
            remaining = int(state.remaining)
            if state.trace is not None:
                req.trace = state.trace
            if remaining < 1:
                # at its budget when extracted: complete, nothing to admit;
                # the request span closes its tree
                req.done = True
                req.finished_at = time.perf_counter()
                self.counters.inc("requests_completed")
                emit_span(
                    self._trace, "request", dur_s=req.finished_at - req.submitted_at,
                    trace=req.trace, src=self._span_src, id=req.id, tokens=len(req.tokens),
                    **_tenant_field(req),
                )
                return
            if state.rng is not None and state.rng_device != self.engine.device.type:
                raise ValueError(
                    f"request {req.id} carries a {state.rng_device} generator state; this "
                    f"server runs on {self.engine.device.type} (a sampled request migrates "
                    "only between servers on one device type)"
                )
            if state.prefix is not None and prefix is None:
                raise ValueError(
                    f"request {req.id} was submitted with a prefix handle: adopt it with "
                    "this server's handle for that prefix (prefix=)"
                )
            embeds = None
            prompt = np.asarray(state.prompt, np.int32)
            if state.embeds is not None:
                # the generated run embedded here (shared weights: the lookup
                # the source's decode steps made), at its own positions
                embeds = np.asarray(state.embeds, np.float32)
                if state.tail.size:
                    tail = self.engine.embed_prompt(state.tail, start=embeds.shape[0])[0]
                    embeds = np.concatenate(
                        [embeds, _as_embeds(tail, self.engine.cache_dtype)], axis=0
                    )
                bucket, chunked, spx = self._plan_request(embeds, remaining, None, chunkable=False)
                prefix = None
            else:
                bucket, chunked, spx = self._plan_request(prompt, remaining, prefix)
            self._check_never_fits(bucket, remaining, spx, chunked)
            req.prompt = prompt
            req.embeds = embeds
            req.prompt_len = int(prompt.shape[0] if embeds is None else embeds.shape[0])
            if state.tenant is not None:
                req.tenant = state.tenant
            req.prefix = prefix
            req.max_new = remaining
            req.baked = len(req.tokens)
            req.carried_rng = None if state.rng is None else np.asarray(state.rng, np.uint8)
            req.row = None
            req.staged_radix = None
            req.stop = stop
            req.spec_k = AdaptiveK(self.speculate) if self.speculate else None
            if front:
                self._queue.appendleft(req)
            else:
                self._queue.append(req)
            self._arm_deadline(req.deadline_at)
            self._span("adopt", req=req, resumed_prompt=req.prompt_len, remaining=remaining,
                       carried_rng=req.carried_rng is not None)
            _update_load_gauges()
        logger.info("adopt id=%d resumed_prompt=%d remaining=%d carried_rng=%s",
                    req.id, req.prompt_len, remaining, req.carried_rng is not None)

    # ---------------------------------------------------------- internals

    def _span(self, name, dur_s=None, req: Optional[Request] = None, **fields):
        """One span to the flight recorder and this server's JSONL trace
        (``server.py:2849``). With ``req``, a CHILD of the request's
        ``request`` span, with its id."""
        if req is not None:
            fields.setdefault("id", req.id)
        emit_span(self._trace, name, dur_s=dur_s, parent_of=None if req is None else req.trace,
                  src=self._span_src, **fields)

    def _resolve_filters(self, top_k, top_p) -> tuple:
        """A request's top-k / top-p against the server's defaults
        (``server.py:2866``)."""
        top_k = self.top_k if top_k is None else int(top_k)
        top_p = self.top_p if top_p is None else validate_top_p(top_p)
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        return top_k, top_p

    def _new_id(self) -> int:
        rid = self._next_id
        self._next_id += 1
        return rid

    def _bucket(self, n: int) -> int:
        for b in ADMIT_BUCKETS:
            if b >= n and b <= self.capacity:
                return b
        raise NeverFits(f"prompt length {n} exceeds admit buckets/capacity ({self.capacity})")

    def _validate_stop(self, stop) -> tuple:
        """Stop strings of a submit (``server.py:3870``): non-empty strings,
        and an engine with a tokenizer to decode the generation."""
        stop = tuple(stop or ())
        if stop:
            if any(not isinstance(x, str) or not x for x in stop):
                raise ValueError("stop must be non-empty strings")
            if self.engine.tokenizer is None:
                raise ValueError(
                    "stop sequences need a tokenizer (engine.tokenizer is None — set "
                    "it on the engine)"
                )
        return stop

    def _hit_stop(self, req: Request) -> bool:
        """True if a stop string appears in the decoded generation
        (``server.py:3883``); on a hit, ``req.tokens`` is cut to the shortest
        prefix whose decoded text holds it (the triggering token kept, as
        an EOS is). The whole generation is decoded each time, so a stop
        spanning token boundaries is caught; ``stop_checked`` starts the
        shortest-prefix scan past the prefixes already found clean."""
        tok = self.engine.tokenizer
        text = tok.decode(req.tokens, skip_special_tokens=True)
        if not any(s in text for s in req.stop):
            req.stop_checked = len(req.tokens)
            return False
        for n in range(req.stop_checked + 1, len(req.tokens) + 1):
            t = tok.decode(req.tokens[:n], skip_special_tokens=True)
            if any(s in t for s in req.stop):
                del req.tokens[n:]
                return True
        return True

    def _chunked(self, bucket: int) -> bool:
        return self.prefill_chunk is not None and bucket > self.prefill_chunk

    def _use_chunked(self, bucket: int, spx_n: int = 0) -> bool:
        """The admission path of a ``bucket``-sized suffix past an
        ``spx_n``-token radix match (JAX ``server.py:3920-3937``), read by
        the admission, the radix plan and the release's insert alike. At
        cp > 1 a hit always goes chunked: its blocks live on their owner
        shards, and only the chunked prefill attends across shards (the
        one-shot path's ``gather_prefix_kv`` reads one arena)."""
        if self.cp > 1 and spx_n > 0:
            return True
        return self._chunked(bucket)

    def _resolve_deadline(self, deadline_s: Optional[float]) -> Optional[float]:
        """Per-request deadline against the server default (``server.py:2877``)."""
        if deadline_s is None:
            return self.default_deadline_s
        deadline_s = float(deadline_s)
        if deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        return deadline_s

    def _check_admission(self) -> None:
        """Backpressure gate on submit, under the mutex (``server.py:2941``)."""
        if self._closed:
            _M_REJECTED.labels(reason="closed").inc()
            raise ServerClosed("server is closed; submit rejected")
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            _M_REJECTED.labels(reason="queue_full").inc()
            raise QueueFull(
                f"submit queue is full ({len(self._queue)} >= max_queue={self.max_queue}); "
                "shed load or retry later"
            )

    def _plan_request(self, prompt: np.ndarray, max_new: int,
                      prefix: Optional[PrefixHandle], chunkable: bool = True) -> tuple:
        """``(bucket, chunked, spx)`` of a request this server could ever
        admit, shared by ``submit``, ``submit_embedding`` (``prompt`` the
        ``[S, H]`` states; never chunked) and ``adopt``; raises ``NeverFits``
        past the capacity or position limit."""
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        if prefix is not None:
            self._validate_prefix_request(prefix, prompt, max_new)
            return self._bucket(prompt.shape[0]), False, prefix.spx
        if prompt.shape[0] < 1:
            raise ValueError("empty prompt")
        bucket = self._bucket(prompt.shape[0])
        chunked = chunkable and self._chunked(bucket)
        total = bucket + max_new + (1 if chunked else 0)
        if total > self.capacity or total > self.cfg.max_position_embeddings:
            raise NeverFits(
                f"prompt bucket ({bucket}) + max_new ({max_new}) needs {total} "
                f"columns; capacity is {self.capacity}, max positions "
                f"{self.cfg.max_position_embeddings}"
            )
        return bucket, chunked, 0

    def _blocks_needed(self, bucket: int, max_new: int, spx: int = 0, chunked: bool = False) -> int:
        """PRIVATE blocks a request needs (``server.py:2957``): the columns
        covering prefix + prompt bucket + budget (+1 for the chunked path's
        injected final prompt token), minus the ``spx / BS`` shared prefix
        blocks the row maps read-only."""
        bs = self.kv_block_size
        cover = spx + bucket + max_new + (1 if chunked else 0)
        return -(-cover // bs) - spx // bs

    def _check_never_fits(self, bucket: int, max_new: int, spx: int, chunked: bool) -> None:
        """``NeverFits`` for a request whose private blocks exceed what the
        pool can ever free: its capacity minus the blocks live handles pin.
        A dense server has no pool: the capacity check was the plan's."""
        if not self.paged:
            return
        need = self._blocks_needed(bucket, max_new, spx, chunked)
        ceiling = self._alloc.capacity_blocks - self._handle_pins
        if need > ceiling:
            pinned = (f" minus {self._handle_pins} pinned by live prefix handles"
                      if self._handle_pins else "")
            raise NeverFits(
                f"request needs {need} KV blocks but the pool holds {ceiling} "
                f"({self.kv_blocks} blocks x {self.kv_block_size}{pinned}); raise "
                "kv_blocks, lower max_new_tokens, or release_prefix unused handles"
            )

    def _validate_prefix_request(self, prefix: PrefixHandle, prompt: np.ndarray, max_new: int) -> None:
        """A handle-bound suffix request (``server.py:2889``): a non-empty
        suffix whose prefix-row layout fits, and a live handle of THIS
        server (its block ids index this pool only)."""
        if prompt.shape[0] < 1:
            raise ValueError(
                "prefix requests need a non-empty suffix (the first token is sampled "
                "from the suffix's last position)"
            )
        bucket = self._bucket(prompt.shape[0])
        if prefix.spx + bucket + max_new > self.capacity:
            raise NeverFits(
                f"prefix rows ({prefix.spx}) + suffix bucket ({bucket}) + max_new "
                f"({max_new}) exceeds server capacity ({self.capacity})"
            )
        total_pos = prefix.n + bucket + max_new
        if total_pos > self.cfg.max_position_embeddings:
            raise NeverFits(
                f"requested {total_pos} positions > max_position_embeddings "
                f"({self.cfg.max_position_embeddings})"
            )
        if not self.paged:
            if prefix.kv is None:
                raise ValueError(
                    "prefix handle carries no KV (a restored stand-in): prefill_prefix "
                    "the prefix again"
                )
            return  # a dense server seeds rows from the handle's KV alone
        if not prefix.owned_by(self) and prefix.blocks is not None:
            raise ValueError(
                "prefix handle belongs to a different server — its block ids index "
                "that server's KV pool, so mapping them here would corrupt live rows; "
                "prefill_prefix on THIS server"
            )
        if prefix.blocks is None:
            if prefix.owner is None:
                raise ValueError(
                    "prefix handle was prefilled on a DENSE server — it carries no KV "
                    "blocks; prefill_prefix on this paged server instead"
                )
            raise ValueError(
                "prefix handle was released (release_prefix) — its shared blocks are "
                "gone; prefill_prefix the prefix again before submitting suffix "
                "requests against it"
            )

    def _free_rows(self) -> list[int]:
        return [i for i, r in enumerate(self._req) if r is None]

    def _live_rows(self, exclude=frozenset()) -> list[int]:
        """Rows whose request is live on the host's mirror (its device row
        may have finished in a log not yet applied)."""
        return [
            i for i, r in enumerate(self._req) if r is not None and not r.done and i not in exclude
        ]

    def _any_active(self, exclude=frozenset()) -> bool:
        return bool(self._live_rows(exclude))

    def _push_tables(self) -> None:
        """The host's tables onto the device, ordered behind the programs in
        flight without waiting for them: on the card from a pinned copy
        taken now, so later edits of the mirror never race the copy. At
        cp > 1 the mirror's global ids are projected into each shard's
        plane of local ids (``server.py:3094-3110``): shard ``s`` keeps ``g %
        kv_blocks`` where it owns ``g`` and maps every other column to its
        trash block 0, so one logical write lands on the owner alone."""
        self.stepline.push("table_push")
        tables = self._tables
        if self.cp > 1:
            nb = self.kv_blocks
            sh = np.arange(self.cp, dtype=np.int32)[:, None, None]
            tables = np.where(tables[None] // nb == sh, tables[None] % nb, 0).astype(np.int32)
        src = torch.from_numpy(np.ascontiguousarray(tables))
        if self.state.block_tables.device.type == "cuda":
            src = src.pin_memory()
        self.state.block_tables.copy_(src, non_blocking=True)
        self._tables_dirty = False
        self.stepline.pop()

    def _flush_tables(self) -> None:
        if self._tables_dirty:
            self._push_tables()

    def _set_health(self, state: str) -> None:
        if state != self._health:
            logger.warning("health %s -> %s", self._health, state)
            self._health = state
        _update_health_gauge()

    # --------------------------------------------- snapshot internals

    def _req_dict(self, r: Optional[Request]) -> Optional[dict]:
        """One request of a snapshot: host values and numpy arrays only.
        The deadline is stored as time remaining (a ``perf_counter`` epoch
        does not survive the process)."""
        if r is None:
            return None
        d = {
            "id": r.id, "prompt": np.asarray(r.prompt, np.int32), "max_new": r.max_new,
            "temperature": r.temperature, "seed": r.seed, "top_k": r.top_k, "top_p": r.top_p,
            "tokens": [int(t) for t in r.tokens], "done": r.done, "row": r.row,
            "baked": r.baked, "stop": list(r.stop), "stop_checked": r.stop_checked,
            "trace": r.trace.to_json(), "tenant": r.tenant,
            "deadline_left": (None if r.deadline_at is None
                              else max(r.deadline_at - time.perf_counter(), 0.0)),
        }
        if r.embeds is not None:
            d["embeds"] = np.asarray(r.embeds, np.float32)
        if r.carried_rng is not None:
            d["carried_rng"] = np.asarray(r.carried_rng, np.uint8)
        if r.prefix is not None:
            d["prefix_n"], d["spx"] = r.prefix.n, r.prefix.spx
        if r.row is not None:
            gen = self.state.rng[r.row]
            if gen is not None:
                d["rng"] = gen.get_state().numpy().copy()
            if self._row_radix[r.row] is not None:
                d["radix_n"] = int(self._row_radix[r.row].n)
        return d

    def _req_from(self, d: dict, now: float) -> Request:
        """A request of a snapshot, revived. A row admitted with a handle
        keeps a released stand-in of it: its blocks are the row's to free,
        and its prompt (the suffix) is never inserted into the tree."""
        prefix = None
        if d.get("spx") is not None:
            prefix = PrefixHandle(None, int(d["prefix_n"]), int(d["spx"]))
        embeds = d.get("embeds")
        r = Request(int(d["id"]), np.asarray(d["prompt"], np.int32), int(d["max_new"]),
                    float(d["temperature"]), int(d["seed"]), int(d["top_k"]),
                    float(d["top_p"]), prefix, stop=tuple(d.get("stop", ())),
                    embeds=None if embeds is None else np.asarray(embeds, np.float32),
                    tenant=d.get("tenant"))
        r.stop_checked = int(d.get("stop_checked", 0))
        tr = TraceContext.from_json(d.get("trace"))
        if tr is not None:
            r.trace = tr
        if self.speculate:
            r.spec_k = AdaptiveK(self.speculate)
        r.tokens = [int(t) for t in d["tokens"]]
        r.done = bool(d["done"])
        r.row = None if d["row"] is None else int(d["row"])
        r.baked = int(d.get("baked", 0))
        if d.get("carried_rng") is not None:
            r.carried_rng = np.asarray(d["carried_rng"], np.uint8)
        if d.get("deadline_left") is not None:
            # the downtime between crash and restore does not count
            r.deadline_at = now + float(d["deadline_left"])
        if r.row is not None:
            r.started_at = now
        if r.tokens:
            # its first token came in the previous process: no false TTFT
            r.first_token_at = r.last_token_at = now
        return r

    def _capture_arena(self, blocks: list) -> dict:
        """The arena's and scales' bytes of ``blocks`` on the host, copied in
        chunks: ``k`` / ``v`` ``[L, n, BS, Nkv, D]`` raw views, and for an
        int8/fp8 arena ``k_scale`` / ``v_scale`` ``[L, n, Nkv]``."""
        quantized = self.state.arenas[0].k_scale is not None
        names = ("k", "v", "k_scale", "v_scale")[: 4 if quantized else 2]
        out = {"blocks": np.asarray(blocks, np.int32)}
        for lo in range(0, len(blocks), _ARENA_CHUNK_BLOCKS):
            chunk = blocks[lo : lo + _ARENA_CHUNK_BLOCKS]
            got = self._read_arena_blocks(chunk)
            for name, a in zip(names, got):
                if name not in out:
                    out[name] = np.empty((a.shape[1], len(blocks)) + a.shape[3:], a.dtype)
                out[name][:, lo : lo + len(chunk)] = a[0]
        return out

    def _restore_arena(self, arena: dict) -> None:
        """``_capture_arena``'s bytes copied into this server's arena, in
        chunks, in place: the device never holds a second arena."""
        blocks = [int(b) for b in arena["blocks"]]
        ar0 = self.state.arenas[0]
        names = ("k", "v", "k_scale", "v_scale")[: 2 if ar0.k_scale is None else 4]
        if blocks and tuple(arena["k"].shape[2:]) != tuple(ar0.k.shape[2:]):
            raise ValueError(
                f"snapshot arena blocks are {arena['k'].shape[2:]}, this server's "
                f"{tuple(ar0.k.shape[2:])}"
            )
        for lo in range(0, len(blocks), _ARENA_CHUNK_BLOCKS):
            chunk = blocks[lo : lo + _ARENA_CHUNK_BLOCKS]
            parts = [arena[n][None, :, lo : lo + len(chunk)] for n in names]
            self._write_arena_blocks(chunk, *parts)

    def _capture_rows(self, rows: list) -> dict:
        """A dense server's held rows on the host, one row's cache at a
        time: ``k`` / ``v`` ``[L, n, C, Nkv, D]`` raw views, the stages'
        layers in chain order."""
        out = {"rows": np.asarray(rows, np.int32)}
        for name in ("k", "v"):
            ts = [getattr(a, name) for a in self.state.arenas]
            parts = [np.concatenate([serve_ops._raw(full_heads(t[:, r])) for t in ts])
                     for r in rows]
            L = sum(t.shape[0] for t in ts)
            out[name] = (np.stack(parts, axis=1) if parts
                         else np.zeros((L, 0) + tuple(ts[0].shape[2:]), np.float32))
        return out

    def _restore_rows(self, arena: dict) -> None:
        """``_capture_rows``'s bytes copied into this dense server's rows,
        each stage taking its layers."""
        rows = [int(r) for r in arena["rows"]]
        ar0 = self.state.arenas[0]
        if rows and tuple(arena["k"].shape[2:]) != tuple(ar0.k.shape[2:]):
            raise ValueError(
                f"snapshot rows are {arena['k'].shape[2:]}, this server's "
                f"{tuple(ar0.k.shape[2:])}"
            )
        for i, r in enumerate(rows):
            lo = 0
            for a in self.state.arenas:
                hi = lo + a.k.shape[0]
                for name in ("k", "v"):
                    t = getattr(a, name)
                    t[:, r] = serve_ops._from_raw(arena[name][lo:hi, i], t.dtype, t.device)
                lo = hi

    def _capture_autosnapshot(self) -> Optional[dict]:
        """End-of-step checkpoint capture under the mutex, once per armed
        interval (``server.py:3812``), through the ``snapshot_write`` site
        with retry. A failure is counted and serving goes on; the interval
        clock advances either way."""
        if self._snapshot_every_s is None:
            return None
        now = time.perf_counter()
        if now - self._last_snapshot_at < self._snapshot_every_s:
            return None
        self._last_snapshot_at = now

        def capture():
            self._fault_check("snapshot_write")
            return self.snapshot()

        try:
            return self._retry("snapshot_write", capture)
        except Exception as e:  # noqa: BLE001 — counted; serving goes on
            _M_SNAPSHOT_FAIL.inc()
            logger.warning("auto-snapshot capture failed: %r", e)
            return None

    def _write_autosnapshot(self, snap: dict) -> None:
        """The disk half of auto-snapshot (``server.py:3839``): a failed
        write is counted, never fatal."""
        try:
            save_snapshot(snap, self._snapshot_path)
        except Exception as e:  # noqa: BLE001 — counted; serving goes on
            _M_SNAPSHOT_FAIL.inc()
            logger.warning("auto-snapshot write failed: %r", e)
        else:
            _M_SNAPSHOTS.inc()

    # --------------------------------------------- resilience internals

    def _fault_check(self, site: str, key=None) -> None:
        if self._fault_plan is not None:
            self._fault_plan.check(site, key=key)

    def _retry(self, site: str, fn, real_ok: bool = True):
        """Run ``fn``, absorbing transient failures with bounded exponential
        backoff (``server.py:3594``); the last failure, or a permanent one,
        propagates to the caller's containment. ``real_ok=False`` retries
        only injected faults, which raise before ``fn`` writes anything:
        the dispatch sites, whose programs write state in place."""
        delays = backoff_delays(self._fault_retries, self._fault_backoff_s)
        retryable = self._retryable if real_ok else ()
        attempt = 0
        while True:
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 — classified right below
                if attempt >= self._fault_retries or not is_transient(e, retryable):
                    raise
                _M_RETRIES.labels(site=site).inc()
                logger.warning("transient failure at %s (attempt %d/%d): %r",
                               site, attempt + 1, self._fault_retries, e)
                if delays[attempt]:
                    time.sleep(delays[attempt])
                attempt += 1

    def _charge_idle(self, t0: float) -> None:
        """A program is dispatched at ``t0``: the device sat idle since the
        newest program's log was seen landing (JAX ``_dispatch_chunk``,
        ``server.py:2529-2537``), charged once. A landing nobody has seen
        yet, or a newest program without a log, charges nothing."""
        e, self._newest = self._newest, None
        if e is not None and e.done_at is not None:
            self.stepline.idle(t0 - e.done_at)

    def _rng_marks(self, rows) -> Optional[dict]:
        """``{row: generator state}`` of the sampled rows among ``rows``,
        taken just before a program that draws from them is launched (a
        host read: a CUDA generator's state lives on the host). None when
        none samples."""
        marks = {}
        for r in rows:
            gen = self.state.rng[r]
            if gen is not None:
                marks[r] = gen.get_state()
        return marks or None

    def _push_pending(self, kind: str, log: torch.Tensor, meta) -> None:
        """A dispatched program's log joins ``_pending``; its copy to the
        host is queued now and read later. It takes the generator marks the
        dispatch left in ``_rng_marks_next``."""
        e = _InFlight(kind, log, meta, self._rng_marks_next)
        self._rng_marks_next = None
        self._pending.append(e)
        self._newest = e

    def _drain(self, max_pending: int) -> int:
        """Apply logs in flight, oldest first, until at most ``max_pending``
        remain (``server.py:4608``). Returns the entries applied. On the
        card each entry's CUDA event is waited on, and the wait is the
        step's blocked time, measured apart from the ``fetch`` phase (a few
        microseconds when the log has landed already); a wait that raises,
        or a read lost past its retries, fails the requests the log carried
        (``_contain_lost_log``) and draining goes on."""
        if len(self._pending) <= max_pending:
            return 0
        applied = 0
        sl = self.stepline
        sl.push("fetch")
        while len(self._pending) > max_pending:
            entry = self._pending.popleft()
            applied += 1
            tb = time.perf_counter()
            try:
                entry.wait_landed()
            except Exception as e:  # noqa: BLE001 — a lost log
                _M_FETCH_FAIL.inc()
                self._contain_lost_log(entry, e)
                continue
            finally:
                if entry.event is not None:
                    sl.blocked(time.perf_counter() - tb)
            self._apply_entry(entry)
        sl.pop()
        return applied

    def _drain_landed(self) -> int:
        """The sidecar's drain (mutex held, ``server.py:4637``): apply every
        entry whose log has landed, oldest first, stopping at the first
        still in flight. Never waits. The stepline calls inside are no-ops
        here: the mutex means the pump is between steps."""
        applied = 0
        while self._pending:
            entry = self._pending[0]
            try:
                if not entry.landed():
                    break
            except Exception as e:  # noqa: BLE001 — a lost log
                self._pending.popleft()
                _M_FETCH_FAIL.inc()
                self._contain_lost_log(entry, e)
                continue
            self._apply_entry(self._pending.popleft())
            applied += 1
        return applied

    def _apply_entry(self, entry: _InFlight) -> bool:
        """Read (``log_fetch``, retried) and apply ONE landed entry
        (``server.py:4650``). False when the read was lost and its requests
        failed."""
        def read():
            self._fault_check("log_fetch")
            return entry.read()

        try:
            value = self._retry("log_fetch", read)
        except Exception as err:  # noqa: BLE001 — the log is lost
            self._contain_lost_log(entry, err)
            return False
        sl = self.stepline
        sl.push("apply")
        if entry.kind == "chunk":
            self._apply_log(value)
        elif entry.kind == "spec":
            self._apply_spec(value, entry.meta)
        else:  # "admit": each row's first token
            for i, (row, req) in enumerate(entry.meta):
                if req.done or self._req[row] is not req:
                    continue  # cancelled between dispatch and apply
                self._apply_token(row, req, int(value[i]))
        sl.pop()
        return True

    def _apply_log(self, log: np.ndarray) -> None:
        """Replay one chunk's ``[cycles, M]`` log into the requests and the
        host mirrors (``server.py:4675``); a row that finished or was
        cancelled after the dispatch is skipped."""
        for step in log:
            for row in np.flatnonzero(step >= 0):
                req = self._req[row]
                if req is None or req.done:
                    continue
                self._apply_token(int(row), req, int(step[row]))

    def _apply_token(self, row: int, req: "Request", t: int) -> None:
        """One token of a chunk or admission log: the host mirror, then the
        request (``_commit``)."""
        serve_ops.commit_log(self.state, row, [t])
        self._commit(row, t)

    def _fail_request(self, req: Request, err: BaseException) -> None:
        """Terminal failure (``server.py:3629``): record the cause, free the
        row's blocks if it holds one (not cached), unblock consumers. The
        caller has stopped the row. The cause is kept without its traceback
        (the containment logged it): the traceback's frames hold the server
        and the request, a cycle that would keep a dropped server's arena and
        weights on the device until the garbage collector ran."""
        e, seen = err, set()
        while e is not None and id(e) not in seen:
            seen.add(id(e))
            e.__traceback__ = None
            e = e.__cause__ or e.__context__
        req.error = err
        req.done = True
        req.finished_at = time.perf_counter()
        self._release_staged(req)
        if req.row is not None and self._req[req.row] is req:
            self._release(req.row)
        self.counters.inc("requests_failed")
        # the tree closes for a failed request too: its postmortem
        emit_span(
            self._trace, "request", dur_s=req.finished_at - req.submitted_at, trace=req.trace,
            src=self._span_src, id=req.id, tokens=len(req.tokens), outcome="failed",
            error=repr(err)[:200], **_tenant_field(req),
        )

    def _contain_rows(self, site: str, victims: list, err) -> None:
        """Contain a persistent failure to exactly the ``(row, request)``
        pairs given (``server.py:3656``): one cancel of their rows, their
        requests failed, health DEGRADED. Every other row keeps decoding and
        the freed rows admit from the queue at the next step. The JAX
        server's admit variant (``:3686``) is this call here; the dispatch
        and lost-log variants name their rows and call it."""
        self._step_contained = True
        self.containment_events += 1
        self._set_health(DEGRADED)
        _M_CONTAINED.labels(site=site).inc()
        victims = [(row, r) for row, r in victims
                   if r is not None and self._req[row] is r and not r.done]
        if victims:
            serve_ops.serve_cancel_rows(self.state, [row for row, _ in victims])
        for _, r in victims:
            self._fail_request(r, err)
        _update_load_gauges()
        logger.warning("contained %s failure (%r): failed request(s) %s",
                       site, err, [r.id for _, r in victims])

    def _contain_dispatch_failure(self, site: str, err) -> None:
        """A decode chunk's dispatch failed past retries (``server.py:3709``):
        apply every log already in flight (the last applied state is the
        truth), then fail the rows the chunk was driving."""
        self._drain(0)
        self._contain_rows(site, [(i, self._req[i]) for i in self._live_rows(self._admitting)],
                           err)

    def _contain_lost_log(self, entry: _InFlight, err) -> None:
        """A log was lost past its retries (``server.py:3722``): the device
        has advanced its rows and the host has not, so the requests whose
        tokens it carried fail and their rows are stopped on the device.
        Every entry names the rows it carried at dispatch (a row admitted
        since is not among them)."""
        if entry.kind == "spec":
            victims = [(row, req) for row, req, _, _ in entry.meta]
        else:
            victims = list(entry.meta)
        self._contain_rows("log_fetch", victims, err)

    def _apply_delta(self, delta) -> bool:
        """Act on the scheduler's published delta at a step boundary (mutex
        held, ``server.py:2463``). Every candidate is re-validated against
        live state: the plan may be a boundary old."""
        now = time.perf_counter()
        SCHEDULER_LAG.observe(now - delta.planned_at)
        shed = False
        doomed = {
            id(r) for r in delta.expire_queued
            if not r.done and r.deadline_at is not None and now >= r.deadline_at
        }
        if doomed:
            keep: collections.deque = collections.deque()
            for r in self._queue:
                if id(r) in doomed:
                    _M_DEADLINE.labels(where="queued").inc()
                    self._fail_request(r, DeadlineExceeded(
                        f"request {r.id} expired after {now - r.submitted_at:.3f}s in queue"
                    ))
                    shed = True
                else:
                    keep.append(r)
            self._queue = keep
        expired = [
            (i, r) for i, r in delta.expire_rows
            if self._req[i] is r and not r.done and r.deadline_at is not None
            and now >= r.deadline_at and i not in self._admitting
        ]
        if expired:
            serve_ops.serve_cancel_rows(self.state, [i for i, _ in expired])
            for _, r in expired:
                _M_DEADLINE.labels(where="in_flight").inc()
                self._fail_request(r, DeadlineExceeded(
                    f"request {r.id} expired mid-decode ({len(r.tokens)}/{r.max_new} tokens)"
                ))
            shed = True
        if shed:
            _update_load_gauges()
        return shed

    def _sweep_gauges(self) -> None:
        """The scheduler thread's paced load-gauge sweep."""
        _update_load_gauges()

    def _arm_deadline(self, deadline_at: Optional[float]) -> None:
        """Tighten the deadline hint for a request entering the queue
        (``server.py:3740``): it stays a lower bound on the earliest live
        deadline, so the step's sweep never misses an expiry."""
        if deadline_at is not None and (
            self._deadline_hint is None or deadline_at < self._deadline_hint
        ):
            self._deadline_hint = deadline_at

    def _shed_expired(self) -> bool:
        """Deadline sweep at the start of a step (``server.py:3751``), once
        the hint has passed: expired queued requests are shed before they
        cost a prefill; expired in-flight rows are stopped with one
        ``serve_cancel_rows`` call. Both fail with ``DeadlineExceeded``; the
        hint is then recomputed exactly."""
        now = time.perf_counter()
        if self._deadline_hint is None or now < self._deadline_hint:
            return False
        shed = False
        keep: collections.deque = collections.deque()
        for r in self._queue:
            if r.deadline_at is not None and now >= r.deadline_at:
                _M_DEADLINE.labels(where="queued").inc()
                self._fail_request(r, DeadlineExceeded(
                    f"request {r.id} expired after {now - r.submitted_at:.3f}s in queue"
                ))
                shed = True
            else:
                keep.append(r)
        self._queue = keep
        expired = [
            r for i, r in enumerate(self._req)
            if r is not None and not r.done and r.deadline_at is not None
            and now >= r.deadline_at and i not in self._admitting
        ]
        if expired:
            serve_ops.serve_cancel_rows(self.state, [r.row for r in expired])
            for r in expired:
                _M_DEADLINE.labels(where="in_flight").inc()
                self._fail_request(r, DeadlineExceeded(
                    f"request {r.id} expired mid-decode ({len(r.tokens)}/{r.max_new} tokens)"
                ))
            shed = True
        if shed:
            _update_load_gauges()
        hints = [r.deadline_at for r in self._queue if r.deadline_at is not None] + [
            r.deadline_at for r in self._req
            if r is not None and not r.done and r.deadline_at is not None
        ]
        self._deadline_hint = min(hints) if hints else None
        return shed

    # ------------------------------------------------ prefix cache internals

    def _read_arena_blocks_dispatch(self, blocks) -> "serve_ops.BlockRead":
        """Dispatch-only half of ``_read_arena_blocks`` (``server.py:3145``):
        queue the block gathers and their copy to pinned host memory, and
        return the ``BlockRead`` without waiting (call its ``numpy()``
        OUTSIDE the mutex). Value-correct though later programs rewrite the
        arena: the gathers are queued on the stream the server's programs
        run on, behind the programs that wrote the blocks and ahead of any
        that reuse them, and they copy. That is what lets the disagg
        hand-off sidecar pull the device→host copy off the router's step
        thread without freezing this server's pump for its duration."""
        self._cp_stream_check(blocks)
        return serve_ops.read_arena_blocks_dispatch(self.state, list(blocks))

    def _read_arena_blocks(self, blocks) -> tuple:
        """Device→host copy of arena blocks (``server.py:3176``): the
        dispatch half plus the wait for its copy."""
        return self._read_arena_blocks_dispatch(blocks).numpy(keep_pinned=False)

    def _write_arena_blocks(self, blocks, k_host, v_host, *scales) -> None:
        """Host→device write of streamed blocks into fresh arena blocks
        (``server.py:3189``), codes and scales byte-exact; queued before
        any program that reads them. At cp > 1 each block lands on its
        owner shard: block bytes do not depend on the shard count, so a
        stream from a server of any cp lands here."""
        self._cp_stream_check(blocks)
        _write_arena_blocks(self.state, blocks, k_host, v_host, *scales)

    def _cp_stream_check(self, blocks) -> None:
        """One block stream through a context-parallel arena, shard by
        shard (``server.py:3125-3139``): the ``cp_shard_stream`` fault probe
        keyed by each owner shard, and one ``server_cp_stream_shards_total``
        sample per shard. A shard whose probe raises counts ``error`` and
        aborts the stream before any device work is queued: the caller
        (hand-off, host tier, snapshot) retries or falls back, never
        half-streams. Nothing at cp 1."""
        if self.cp <= 1:
            return
        for sh in self._alloc.owner_shards(blocks):
            try:
                self._fault_check("cp_shard_stream", key=sh)
            except BaseException:
                CP_STREAM_SHARDS.labels(outcome="error").inc()
                raise
            CP_STREAM_SHARDS.labels(outcome="ok").inc()

    def _radix_plan(self, req: Request):
        """The longest usable cached prefix of a queued request, taken
        (pinned, demoted nodes streamed back) as a ``RadixRef``, or None
        (``server.py:3242``). Usable: block-aligned, at least one suffix
        token left, and the layout ``n + bucket(suffix) + max_new`` (+1 if
        the suffix admits chunked) fits the capacity and positions."""
        if self._radix is None or req.prefix is not None or req.embeds is not None:
            return None
        plen = req.prompt_len
        bs = self.kv_block_size
        m = self._radix.match_tokens(req.prompt)
        m = min(m, ((plen - 1) // bs) * bs)

        def usable(n: int) -> bool:
            bucket = self._bucket(plen - n)
            total = n + bucket + req.max_new + (1 if self._use_chunked(bucket, n) else 0)
            return total <= self.capacity and total <= self.cfg.max_position_embeddings

        while m > 0 and not usable(m):
            m -= bs
        if m <= 0:
            return None
        ref = self._radix.take(req.prompt, m)
        if ref is None:
            return None
        if ref.n != m and not usable(ref.n):
            # a demoted node could not stream back and the truncated match
            # no longer lays out: admit cold
            self._radix.release(ref)
            return None
        return ref

    def _stage_radix_plan(self) -> None:
        """Take the queue head's radix plan one step ahead of its admission
        (``server.py:3290``), after this step's decode, so a host-tier
        restore is queued behind that work. Pinned, so the path cannot be
        evicted while the request waits."""
        head = self._queue[0]
        if head.staged_radix is not None or head.prefix is not None or head.embeds is not None:
            return
        head.staged_radix = self._radix_plan(head)

    def _release_staged(self, req: Request) -> None:
        if req.staged_radix is not None and self._radix is not None:
            self._radix.release(req.staged_radix)
        req.staged_radix = None

    def _map_row_blocks(self, row: int, bucket: int, max_new: int, spx: int, shared,
                        chunked: bool) -> None:
        """Allocate a row's private blocks and build its table
        (``server.py:2995``): shared prefix blocks first (read-only,
        refcounted), private blocks through the budget, trash after. The
        gate counted evictable tree blocks as free; evict them now."""
        bs = self.kv_block_size
        n_pfx = spx // bs
        need = self._blocks_needed(bucket, max_new, spx, chunked)
        if self._radix is not None and need > self._alloc.num_free:
            self._radix.ensure_free(need)
        # the placement hint stripes a context-parallel row over the shards
        priv = self._alloc.alloc_at(n_pfx, need)
        self._row_blocks[row] = priv
        tbl = self._tables[row]
        tbl[:] = 0
        if shared:
            self._alloc.share(shared)
            self._row_shared[row] = list(shared)
            tbl[:n_pfx] = shared
        tbl[n_pfx : n_pfx + len(priv)] = priv

    def _release(self, row: int, insert: bool = False) -> None:
        """Remap the row's table to trash, then free its blocks
        (``server.py:3022-3089``). With the cache on and ``insert`` (a clean
        finish, a cancel or an extract: the prompt's KV is complete) the
        blocks of the block-aligned prompt go into the tree instead; a
        chunk-admitted row's final prompt token entered by the decode path,
        past the bucket, so its cacheable run ends one token early."""
        req = self._req[row]
        self.state.rng[row] = None  # the row's generator stops drawing
        self._req[row] = None
        if req is not None:
            req.row = None
        if not self.paged:
            return  # the row owns its cache: nothing to free
        priv, shared = self._row_blocks[row], self._row_shared[row]
        rref = self._row_radix[row]
        consumed: set = set()
        if (insert and self._radix is not None and req is not None and req.prefix is None
                and req.embeds is None):
            bs = self.kv_block_size
            plen = req.prompt_len
            spx_n = rref.n if rref is not None else 0
            chunked = plen > spx_n and self._use_chunked(self._bucket(plen - spx_n), spx_n)
            nb = (plen - (1 if chunked else 0)) // bs
            cand = [int(b) for b in self._tables[row][:nb]]
            if nb > 0 and 0 not in cand:
                consumed = self._radix.insert(np.asarray(req.prompt[: nb * bs], np.int32), cand)
        self._tables[row] = 0
        self._tables_dirty = True
        self._alloc.free([b for b in priv if b not in consumed])
        if shared:
            self._alloc.free(shared)
        if rref is not None:
            self._radix.release(rref)
        self._row_blocks[row] = []
        self._row_shared[row] = []
        self._row_radix[row] = None

    def _admit_pending(self) -> bool:
        """FIFO admission into free rows (``server.py:3954-4048``): the queue
        head, with its radix plan or handle, and the requests right behind
        it that co-admit with it. Without a prefix, co-admission means the
        same prompt bucket; with a radix hit, the same matched prefix, the
        same suffix bucket and a layout that fits; with a handle, the same
        handle; embedding requests only with embedding requests of the same
        bucket (``server.py:3979-4049``). Every request must fit the free
        blocks, counting the cold tree blocks eviction can free (a dense
        server needs only the free rows)."""
        admitted = False
        free = self._free_rows()
        while self._queue and free:
            head = self._queue[0]
            pfx = head.prefix
            if self.paged and pfx is not None and pfx.blocks is None:
                self._queue.popleft()
                self._fail_request(head, ValueError(
                    "prefix handle was released while the request was queued — its "
                    "shared KV blocks are gone; prefill_prefix again and resubmit"
                ))
                continue
            rplan, head.staged_radix = head.staged_radix, None
            if rplan is None and self._radix is not None and pfx is None:
                self.stepline.push("radix_plan")
                rplan = self._radix_plan(head)
                self.stepline.pop()
            spx_n = 0 if rplan is None else rplan.n
            bucket = self._bucket(head.prompt_len - spx_n)
            is_emb = head.embeds is not None
            # the suffix bucket picks the path (a hit at cp > 1 goes
            # chunked); embeddings admit one-shot
            chunked = pfx is None and not is_emb and self._use_chunked(bucket, spx_n)
            spx = pfx.spx if pfx is not None else spx_n
            free_left = None  # dense: no pool to gate on
            if self.paged:
                free_left = self._alloc.num_free + (
                    self._radix.evictable_blocks() if self._radix is not None else 0
                )
                need = self._blocks_needed(bucket, head.max_new, spx, chunked)
                if need > free_left:
                    if rplan is not None:
                        self._radix.release(rplan)
                    logger.info("admission waits: request %d needs more KV blocks "
                                "than the %d free", head.id, self._alloc.num_free)
                    break
                free_left -= need

            def co_admits(r: Request) -> bool:
                if r.prefix is not pfx or (r.embeds is not None) != is_emb:
                    return False
                if rplan is None:
                    return self._bucket(r.prompt_len) == bucket
                total = spx_n + bucket + r.max_new + (1 if chunked else 0)
                return (
                    r.prompt_len > spx_n
                    and self._bucket(r.prompt_len - spx_n) == bucket
                    and total <= self.capacity
                    and total <= self.cfg.max_position_embeddings
                    and bool(np.array_equal(r.prompt[:spx_n], head.prompt[:spx_n]))
                )

            batch = [self._queue.popleft()]
            while len(batch) < len(free) and self._queue and co_admits(self._queue[0]):
                if free_left is not None:
                    need = self._blocks_needed(bucket, self._queue[0].max_new, spx, chunked)
                    if need > free_left:
                        break
                    free_left -= need
                batch.append(self._queue.popleft())
            rows = free[: len(batch)]
            free = free[len(batch):]
            admitted |= self._admit(batch, rows, bucket, chunked, pfx, rplan)
        return admitted

    def _admit(self, batch: list, rows: list, bucket: int, chunked: bool,
               pfx: Optional[PrefixHandle], rplan) -> bool:
        """Map the batch's rows and admit it through the ``admit_dispatch``
        site (retried for injected faults only); a failure past the retries
        fails exactly this batch. A one-shot admission's first tokens join
        ``_pending`` as an ``"admit"`` entry, applied like a chunk log.
        True if admitted."""
        n = len(batch)
        t_admit0 = time.perf_counter()
        spx_n = 0 if rplan is None else rplan.n
        spx = pfx.spx if pfx is not None else spx_n
        shared = pfx.blocks if pfx is not None else (rplan.blocks if rplan is not None else None)
        prompts = np.zeros((n, bucket), np.int32)
        plen = np.zeros(n, np.int64)
        max_new = np.zeros(n, np.int64)
        seeds = np.zeros(n, np.int64)
        temps = np.zeros(n, np.float32)
        topks = np.zeros(n, np.int32)
        topps = np.ones(n, np.float32)
        rng_states = [r.carried_rng for r in batch]
        embeds = None
        if batch[0].embeds is not None:  # the batch enters as hidden states
            embeds = np.zeros((n, bucket, self.cfg.hidden_size), np.float32)
        now = time.perf_counter()
        for i, (r, row) in enumerate(zip(batch, rows)):
            if embeds is not None:
                embeds[i, : r.prompt_len] = r.embeds
                plen[i] = r.prompt_len
            else:
                # with a radix hit the device sees only the suffix
                sfx = r.prompt[spx_n:]
                prompts[i, : len(sfx)] = sfx
                plen[i] = len(sfx)
            max_new[i], seeds[i] = r.max_new, r.seed
            temps[i], topks[i], topps[i] = r.temperature, r.top_k, r.top_p
            r.row = row
            r.carried_rng = None  # consumed by this admission
            r.started_at = now
            _M_QUEUE_WAIT.observe(now - r.submitted_at, trace_id=r.trace.trace_id)
            self._req[row] = r
            if self.paged:
                self._map_row_blocks(row, bucket, r.max_new, spx, shared, chunked)
            if rplan is not None:
                if i > 0:  # one pin per mapping row; take() pinned the first
                    self._radix.pin(rplan)
                self._row_radix[row] = rplan
            if self._radix is not None and pfx is None and embeds is None:
                self._radix.eligible_tokens += r.prompt_len
                self._radix.hit_tokens += spx_n
                if spx_n:
                    # the take() recorded where each matched token lived;
                    # later rows of the batch reuse arena-resident blocks
                    tiers = rplan.tier_tokens if i == 0 else {"hbm": spx_n}
                    for tier, tok in tiers.items():
                        if tok:
                            PREFIX_HIT_TOKENS.labels(tier=tier).inc(tok)
        if self.paged:
            self._push_tables()  # the admission writes exactly the blocks just mapped
        ADMIT_BUCKET_USED.labels(bucket=str(bucket)).inc()
        sampling = (seeds, temps, topks, topps)

        def dispatch():
            self._fault_check("admit_dispatch")
            if chunked:
                self._admit_chunked(rows, prompts, plen, max_new, sampling,
                                    prefix_off=spx_n, rng_states=rng_states)
                return None
            pkv, pn = None, 0
            if pfx is not None:
                pkv, pn = pfx.kv, pfx.n
            elif rplan is not None:
                pkv = serve_ops.gather_prefix_kv(self.state, rplan.blocks, self.engine.cache_dtype)
                pn = spx_n
            return serve_ops.serve_admit(
                self.cfg, self.model, self.state, rows, prompts, plen, max_new, *sampling,
                prefix_kv=pkv, prefix_len=pn, prefix_in_arena=rplan is not None,
                rng_states=rng_states, prompt_embeds=embeds,
            )

        sl = self.stepline
        self._charge_idle(time.perf_counter())
        sl.push("dispatch")
        try:
            tok0 = self._retry("admit_dispatch", dispatch, real_ok=False)
        except Exception as e:  # noqa: BLE001 — contained to this batch: its
            # rows stay parked and admit others later (server.py:3686)
            sl.pop()
            self._contain_rows("admit_dispatch", [(r.row, r) for r in batch], e)
            return False
        if tok0 is not None:
            # a row's draws before this admission: its carried state, or
            # None (the request's seed)
            marks = {row: st for r, row, st in zip(batch, rows, rng_states)
                     if r.temperature > 0}
            self._rng_marks_next = marks or None
            self._push_pending("admit", tok0, [(r.row, r) for r in batch])
        sl.pop()
        self.counters.inc("admissions")
        dt_admit = time.perf_counter() - t_admit0
        self._span("admit", dur_s=dt_admit, rows=list(rows), ids=[r.id for r in batch],
                   bucket=bucket, chunked=chunked, n=n)
        for r in batch:
            if self._radix is not None and pfx is None and embeds is None:
                # the cache consult's outcome: was a slow request a miss?
                self._span("radix", req=r, hit=spx_n, prompt=r.prompt_len)
            self._span("prefill", dur_s=dt_admit, req=r, row=r.row, bucket=bucket,
                       chunked=chunked, n=n,
                       queue_wait_s=round(r.started_at - r.submitted_at, 6))
        return True

    def _admit_chunked(self, rows, prompts, plen, max_new, sampling, prefix_off: int = 0,
                       rng_states=None) -> None:
        """Bounded chunks with one decode step of the OTHER live rows after
        each, so a long admission never stalls live streams: the decode
        chunk joins ``_pending`` and the logs drain to ``pipeline_depth``
        (``server.py:4432-4439``). Each row's final prompt token is masked
        out of the prefill and fed by the first decode step instead.
        ``prefix_off`` > 0 is a radix hit: the suffix starts at that
        position and column, over the matched blocks already resident
        (``server.py:4323-4470``)."""
        n, bucket = prompts.shape
        Sc = self.prefill_chunk
        idx = np.arange(bucket)[None, :]
        positions = np.where(idx < plen[:, None], prefix_off + idx, POS_SENTINEL).astype(np.int32)
        positions[np.arange(n), plen - 1] = POS_SENTINEL
        self._admitting.update(rows)
        set_prefill_path(self.prefill_path)
        try:
            for ci, off in enumerate(range(0, bucket, Sc)):
                self._flush_tables()
                self._charge_idle(time.perf_counter())
                if self.paged:
                    # the blocks this chunk's queries attend: each row's
                    # written frontier (prefix + chunks through this one)
                    PREFILL_BLOCKS_READ.inc(n * -(-(prefix_off + off + Sc) // self.kv_block_size))
                serve_ops.serve_prefill_chunk(
                    self.cfg, self.model, self.state, rows, prompts[:, off : off + Sc],
                    positions[:, off : off + Sc], off, ci == 0, self.attn_backend,
                    prefix_off=prefix_off,
                )
                # the admitting rows are parked (done) on the device: the
                # chunk over every row leaves them alone
                if self._any_active(exclude=self._admitting):
                    self._dispatch_chunk(cycles=1)
                    self._drain(self.pipeline_depth)
        finally:
            self._admitting.difference_update(rows)
        last_tok = prompts[np.arange(n), plen - 1]
        serve_ops.serve_admit_finish(self.state, rows, last_tok, prefix_off + plen, max_new,
                                     *sampling, rng_states=rng_states)

    @property
    def attn_path(self) -> str:
        """This server's ``server_attn_backend`` label: ``kernel`` (the CUDA
        paged kernel), ``xla`` (the plain paged path) or ``dense``."""
        if not self.paged:
            return "dense"
        return "kernel" if self.attn_backend == "kernel" else "xla"

    @property
    def prefill_path(self) -> str:
        """This server's ``server_prefill_path`` label: ``kernel``, ``xla``
        (the plain paged path) or ``gather`` (dense)."""
        return "gather" if not self.paged else self.attn_path

    def _record_blocks_read(self, rows, steps: int = 1) -> None:
        """Feed ``server_attn_blocks_read_total`` from the host length
        mirrors (``server.py:1538-1552``): ``ceil(len / block_size)`` blocks
        per row per decode or verify step, an estimate (the mirrors trail
        the device by the logs in flight) that reads nothing from the
        device."""
        if not self.paged:
            return
        bs = self.kv_block_size
        blocks = sum(-(-max(int(self.state.mirror_len[r]), 1) // bs) for r in rows)
        if blocks:
            ATTN_BLOCKS_READ.inc(blocks * steps)

    def _dispatch_chunk(self, cycles: Optional[int] = None) -> None:
        """Dispatch one decode chunk over every row (``serve_chunk``,
        ``cycles`` steps, default ``chunk_cycles``) through the
        ``chunk_dispatch`` site, injected faults retried; a failure past the
        retries fails the live rows (``_contain_dispatch_failure``). Its log
        joins ``_pending``: nothing waits for the device here (JAX
        ``_dispatch_chunk``, ``server.py:2525-2597``)."""
        t0 = time.perf_counter()
        self._charge_idle(t0)
        sl = self.stepline
        sl.push("dispatch")
        cycles = self.chunk_cycles if cycles is None else cycles

        def do_chunk():
            self._fault_check("chunk_dispatch")
            return serve_ops.serve_chunk(
                self.cfg, self.model, self.state, cycles, self.attn_backend
            )

        self._flush_tables()
        marks = self._rng_marks(range(self.rows))
        t_dispatch = time.perf_counter()
        try:
            log = self._retry("chunk_dispatch", do_chunk, real_ok=False)
        except Exception as e:  # noqa: BLE001 — contained to the live rows
            sl.pop()
            self._contain_dispatch_failure("chunk_dispatch", e)
            return
        if self.cp > 1:
            CP_COMBINE_SECONDS.observe(time.perf_counter() - t_dispatch)
        # the rows the chunk drives on the device: the ones a lost log fails
        live = [(i, self._req[i]) for i in self._live_rows(exclude=self._admitting)]
        self._rng_marks_next = marks
        self._push_pending("chunk", log, live)
        self._record_blocks_read([i for i, _ in live], steps=cycles)
        self.counters.inc("chunks")
        self._span("chunk", dur_s=time.perf_counter() - t0, cycles=cycles, rows=len(live))
        sl.pop()

    def _spec_step(self) -> None:
        """One speculative round (``server.py:4473``): draft up to each live
        row's ``AdaptiveK`` width from its own ids (the prompt, with a
        handle the suffix only, and the applied tokens not yet folded into
        it by a migration), verify every live row in one ``serve_verify``
        through the ``chunk_dispatch`` site (injected faults retried; a
        failure past the retries fails these rows), and queue its commit
        log as a ``"spec"`` entry; the step drains it at once.

        A row admitted in this step drafts from its prompt alone: its first
        token's ``"admit"`` entry is still in flight, as in the JAX server
        (``server.py:2253-2270``), so both packages propose the same drafts
        and their ``spec_*`` counters agree. The verify itself feeds that
        token from the row state on the device."""
        K = self.speculate
        rows = self._live_rows()
        n = len(rows)
        draft = np.zeros((n, K), np.int32)
        draft_len = np.zeros(n, np.int32)
        for i, row in enumerate(rows):
            req = self._req[row]
            ids = np.concatenate([np.asarray(req.prompt, np.int64),
                                  np.asarray(req.tokens[req.baked :], np.int64)])
            d = ngram_draft(ids, req.spec_k.k, self.spec_ngram)
            draft[i, : d.shape[0]] = d
            draft_len[i] = d.shape[0]
        t0 = time.perf_counter()
        self._charge_idle(t0)

        def do_verify():
            self._fault_check("chunk_dispatch")
            return serve_ops.serve_verify(
                self.cfg, self.model, self.state, rows, draft, draft_len, self.attn_backend
            )

        self._flush_tables()
        marks = self._rng_marks(rows)
        try:
            log = self._retry("chunk_dispatch", do_verify, real_ok=False)
        except Exception as e:  # noqa: BLE001 — contained to these rows
            self._contain_rows("chunk_dispatch", [(r, self._req[r]) for r in rows], e)
            return
        self._rng_marks_next = marks
        self._push_pending("spec", log, [
            (row, self._req[row], int(draft_len[i]), draft[i].copy())
            for i, row in enumerate(rows)
        ])
        self._record_blocks_read(rows)
        self.counters.inc("chunks")
        self._span("chunk", dur_s=time.perf_counter() - t0, rows=n)

    def _apply_spec(self, log: np.ndarray, entries: list) -> None:
        """Replay one verify's ``[n, K+1]`` log (``server.py:4574``): the
        host mirrors take each row's whole run (``commit_verify``), then
        every token goes through the same per-token commit as a chunk's, so
        a stop string that hits mid-run cuts the run there. The row's
        ``AdaptiveK`` and the spec metrics update from (drafted, accepted).
        A row whose request finished or left since the dispatch is
        skipped."""
        serve_ops.commit_verify(self.cfg, self.state, [e[0] for e in entries], log)
        for i, (row, req, drafted, draft_row) in enumerate(entries):
            if self._req[row] is not req or req.done:
                continue
            committed = [int(t) for t in log[i] if t >= 0]
            # the leading match, not len - 1: a run cut by an accepted stop
            # id or the budget has no bonus token
            accepted = count_accepted(committed, draft_row, drafted)
            req.spec_k.update(drafted, accepted)
            observe(drafted, accepted, len(committed))
            for j, t in enumerate(committed):
                if req.done or self._req[row] is not req:
                    break  # a stop string or a containment ended it mid-run
                self._commit(row, t, last=j == len(committed) - 1)

    def _commit(self, row: int, t: int, last: bool = True) -> None:
        """One generated token → its request, through the ``request_apply``
        site keyed by the request id (a permanent fault there fails that
        request only); the latency histograms; the stop-string scan. The
        host mirror has taken the token already. The row finishes at the
        ``last`` token of the program's run when that is a stop id or the
        mirror reaches its budget (the device finished the row at the same
        token), or at a stop string (the row is then stopped on the device);
        its prompt blocks go into the prefix cache."""
        req = self._req[row]
        if self._fault_plan is not None:
            try:
                self._retry("request_apply",
                            lambda: self._fault_check("request_apply", key=req.id))
            except Exception as e:  # noqa: BLE001 — contained to this request
                self._contain_rows("request_apply", [(row, req)], e)
                return
        req.tokens.append(t)
        # a deep-capture exemplar: a no-op unless a capture is armed
        self.stepline.note_exemplar(req.trace.trace_id)
        now = time.perf_counter()
        tid = req.trace.trace_id
        if req.first_token_at is None:
            req.first_token_at = now
            req.decode_mark = (0, now)
            _M_TTFT.observe(now - req.submitted_at, trace_id=tid)
        else:
            _M_INTERTOKEN.observe(now - req.last_token_at, trace_id=tid)
        req.last_token_at = now
        self.counters.inc("tokens_generated")
        if req.decode_mark is None:
            # revived mid-decode (restore sets first_token_at): a fresh bucket
            req.decode_mark = (len(req.tokens) - 1, now)
        mark_n, mark_t = req.decode_mark
        if len(req.tokens) - mark_n >= DECODE_SPAN_TOKENS:
            self._span("decode", dur_s=now - mark_t, req=req, tokens=len(req.tokens) - mark_n,
                       row=row)
            req.decode_mark = (len(req.tokens), now)
        st = self.state
        finished = last and (t in self._stop_ids or st.mirror_len[row] >= st.mirror_budget[row])
        if req.stop and self._hit_stop(req):
            # the decoded text holds a stop string: the tokens are cut to it
            # and the row stops
            serve_ops.serve_cancel_rows(self.state, [row])
            finished = True
        if finished:
            req.done = True
            req.finished_at = now
            self._release(row, insert=True)
            self.counters.inc("requests_completed")
            dur = now - (req.started_at or now)
            ntok = len(req.tokens)
            tok_s = ntok / dur if dur > 0 else 0.0
            _M_REQUEST.observe(now - req.submitted_at, trace_id=tid)
            _M_TOK_S.observe(tok_s)
            # the final partial decode bucket, then the request's root span
            mark_n, mark_t = req.decode_mark
            if ntok > mark_n:
                self._span("decode", dur_s=now - mark_t, req=req, tokens=ntok - mark_n, row=row)
            queue_wait = req.started_at - req.submitted_at if req.started_at is not None else 0.0
            emit_span(
                self._trace, "request", dur_s=now - req.submitted_at, trace=req.trace,
                src=self._span_src, id=req.id, tokens=ntok, queue_wait_s=round(queue_wait, 6),
                ttft_s=round(req.first_token_at - req.submitted_at, 6), tok_s=round(tok_s, 2),
                **_tenant_field(req),
            )
