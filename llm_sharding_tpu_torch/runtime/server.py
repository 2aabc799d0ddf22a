"""Continuous-batching server over the paged KV arena, one GPU: the port of
``llm_sharding_tpu/runtime/server.py`` ``PipelineServer`` (``:885``) with
``submit`` / ``step`` / ``stream`` / ``result`` / ``cancel`` / ``close`` /
``run_until_idle``.

It schedules ``M = batch_per_slot`` independent rows (the JAX server's
``num_stages × batch_per_slot`` on one stage). Each ``step`` admits queued
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

Not in this slice: dense serving, speculation, faults, deadlines,
snapshots (of the server and of the tree), metrics and traces.
"""

from __future__ import annotations

import collections
import functools
import logging
import threading
import time
import weakref
from typing import Iterator, Optional

import numpy as np
import torch

from ..models.cache import POS_SENTINEL
from ..ops.quant import KV_DTYPES, fp8_kv_supported, kv_storage_dtype
from ..ops.sampling import validate_top_p
from ..parallel import serve as serve_ops
from .blocks import BlockAllocator
from .radix import RadixCache

logger = logging.getLogger(__name__)

# Admission prompt buckets (``server.py:317``).
ADMIT_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768)


class NeverFits(ValueError):
    """The request can never be admitted: its prompt bucket plus budget
    exceeds the server's capacity or position limit, or it needs more KV
    blocks than the pool holds."""


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
    (``server.py:3176``)."""
    return serve_ops.read_arena_blocks(state, list(blocks))


def _write_arena_blocks(state, blocks, k_host, v_host, *scales) -> None:
    """Host→device restore of demoted blocks into fresh arena blocks
    (``server.py:3189``), codes and scales byte-exact; queued before the
    admission that reads them."""
    if state.k_scale is None:
        serve_ops.write_arena_blocks(state.k, state.v, list(blocks), k_host, v_host)
    else:
        serve_ops.write_arena_blocks_q(
            state.k, state.v, state.k_scale, state.v_scale, list(blocks), k_host, v_host, *scales
        )


class ServerClosed(RuntimeError):
    """The server was closed."""


class RequestFailed(RuntimeError):
    """The request did not finish (its cause is chained)."""


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
    remembers (weakly) the server that made it."""

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
                 seed: int, top_k: int, top_p: float, prefix: Optional[PrefixHandle] = None):
        self.id = rid
        self.prompt = prompt  # with a handle: the suffix only
        self.prompt_len = int(prompt.shape[0])
        self.max_new = max_new
        self.temperature = temperature
        self.seed = seed
        self.top_k = top_k
        self.top_p = top_p
        self.prefix = prefix
        # a radix match taken (pinned) one step ahead of admission
        self.staged_radix = None
        self.tokens: list[int] = []
        self.done = False
        self.row: Optional[int] = None
        self.error: Optional[BaseException] = None
        self.submitted_at = time.perf_counter()
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None


class PipelineServer:
    """Continuous batching over an ``Engine``'s weights on its device."""

    def __init__(
        self,
        engine,
        *,
        capacity: int = 1024,
        batch_per_slot: int = 1,
        prefill_chunk: Optional[int] = None,
        kv_block_size: int,
        kv_blocks: int,
        kv_dtype: str = "bf16",
        paged_attn: str = "auto",
        prefix_cache: str = "off",
        host_pool_blocks: int = 0,
        disk_pool_dir: Optional[str] = None,
        disk_pool_blocks: int = 0,
    ):
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
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
        if kv_block_size < 1 or kv_block_size & (kv_block_size - 1):
            raise ValueError(f"kv_block_size must be a power of two, got {kv_block_size}")
        _validate_prefix_cache(prefix_cache, host_pool_blocks, disk_pool_dir, disk_pool_blocks)
        self.engine = engine
        self.cfg = engine.cfg
        self.params = engine.params
        self.capacity = int(capacity)
        self.rows = int(batch_per_slot)
        self.prefill_chunk = prefill_chunk
        self.kv_block_size = int(kv_block_size)
        self.kv_blocks = int(kv_blocks)
        self.kv_dtype = kv_dtype
        #: the arena's storage dtype (engine.cache_dtype stays the compute dtype)
        self.kv_store_dtype = kv_storage_dtype(kv_dtype, engine.cache_dtype)
        #: the paged attention backend every serve program runs
        self.attn_backend = (
            "kernel" if paged_attn != "plain" and engine.device.type == "cuda" else "plain"
        )
        self._alloc = BlockAllocator(self.kv_blocks, self.kv_block_size)
        # blocks pinned by live prefix handles: only release_prefix frees them
        self._handle_pins = 0
        self.state = serve_ops.make_state(
            self.cfg, self.rows, capacity=self.capacity, kv_blocks=self.kv_blocks,
            kv_block_size=self.kv_block_size, dtype=engine.cache_dtype, device=engine.device,
            kv_dtype=kv_dtype,
        )
        # host mirror of the device block tables; pushed before each dispatch
        # that reads them once a release or a mapping edited it
        self._tables = np.zeros(tuple(self.state.block_tables.shape), np.int32)
        self._tables_dirty = False
        self._row_blocks: list[list[int]] = [[] for _ in range(self.rows)]  # private
        self._row_shared: list[list[int]] = [[] for _ in range(self.rows)]  # mapped read-only
        self._row_radix: list = [None] * self.rows  # each row's pinned RadixRef
        self._req: list[Optional[Request]] = [None] * self.rows
        self._admitting: set[int] = set()
        self._queue: collections.deque[Request] = collections.deque()
        self._next_id = 0
        self._closed = False
        self._mutex = threading.RLock()
        # automatic prefix cache: the host tier defaults to an arena's worth
        # of blocks, the disk tier below it to another (server.py:1160-1175)
        self.prefix_cache = prefix_cache
        tiered = prefix_cache in ("host", "disk")
        self.host_pool_blocks = int(host_pool_blocks or self.kv_blocks) if tiered else 0
        self.disk_pool_dir = disk_pool_dir if prefix_cache == "disk" else None
        self.disk_pool_blocks = (
            int(disk_pool_blocks or self.kv_blocks) if prefix_cache == "disk" else 0
        )
        self._radix: Optional[RadixCache] = None
        if prefix_cache != "off":
            # the callbacks close over the state, not the server: a bound
            # method would make a server <-> tree cycle, and a dropped
            # server's arena would wait for the garbage collector
            self._radix = RadixCache(
                self._alloc, self.kv_block_size, host_pool_blocks=self.host_pool_blocks,
                read_kv=functools.partial(_read_arena_blocks, self.state),
                write_kv=functools.partial(_write_arena_blocks, self.state),
                disk_pool_dir=self.disk_pool_dir, disk_pool_blocks=self.disk_pool_blocks,
            )
            if self.disk_pool_blocks:
                # the pool outlives the process: re-index what the last one left
                self._radix.adopt_pool()

    # ---------------------------------------------------------------- API

    def submit(
        self,
        prompt_ids,
        max_new_tokens: int = 128,
        *,
        temperature: float = 0.0,
        seed: int = 0,
        top_k: int = 0,
        top_p: float = 1.0,
        prefix: Optional[PrefixHandle] = None,
    ) -> Request:
        """Enqueue a request; it is admitted by a later ``step``. Raises
        ``NeverFits`` for a request no amount of waiting could admit and
        ``ServerClosed`` after ``close``. With ``prefix`` (a handle of this
        server's ``prefill_prefix``) ``prompt_ids`` is the suffix only:
        generation equals submitting ``prefix + suffix`` whole, and the
        admission is one-shot."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        top_p = validate_top_p(top_p)
        if prefix is None:
            if prompt.shape[0] < 1:
                raise ValueError("empty prompt")
            bucket = self._bucket(prompt.shape[0])
            chunked = self._chunked(bucket)
            total = bucket + max_new_tokens + (1 if chunked else 0)
            if total > self.capacity or total > self.cfg.max_position_embeddings:
                raise NeverFits(
                    f"prompt bucket ({bucket}) + max_new ({max_new_tokens}) needs {total} "
                    f"columns; capacity is {self.capacity}, max positions "
                    f"{self.cfg.max_position_embeddings}"
                )
            spx = 0
        else:
            self._validate_prefix_request(prefix, prompt, max_new_tokens)
            bucket, chunked, spx = self._bucket(prompt.shape[0]), False, prefix.spx
        with self._mutex:
            if self._closed:
                raise ServerClosed("server is closed; submit rejected")
            self._check_never_fits(bucket, max_new_tokens, spx, chunked)
            req = Request(self._next_id, prompt, int(max_new_tokens), float(temperature),
                          int(seed), int(top_k), top_p, prefix)
            self._next_id += 1
            self._queue.append(req)
        return req

    def prefill_prefix(self, prefix_ids) -> PrefixHandle:
        """Prefill a shared prefix once (``server.py:1637``) and return its
        handle. The prefix is padded to an admission bucket, at least one
        block, so its blocks are exactly the table entries ``[0, spx /
        block_size)``; suffix positions resume at its real length ``n``."""
        prefix = np.asarray(prefix_ids, np.int32).reshape(-1)
        n = int(prefix.shape[0])
        if n < 1:
            raise ValueError("prefix must be non-empty")
        spx = max(self._bucket(n), self.kv_block_size)
        if spx + 1 > self.capacity:
            raise ValueError(f"prefix bucket ({spx}) exceeds server capacity ({self.capacity})")
        buf = np.zeros((1, spx), np.int32)
        buf[0, :n] = prefix
        with self._mutex:
            if self._closed:
                raise ServerClosed("server is closed; prefill_prefix rejected")
            kv = serve_ops.prefix_prefill(
                self.cfg, self.params, buf, n, self.engine.cache_dtype, self.engine.device
            )
            need = spx // self.kv_block_size
            if self._radix is not None and need > self._alloc.num_free:
                # cold cached prefixes make way for an explicit, pinned handle
                self._radix.ensure_free(need)
            blocks = self._alloc.alloc(need)
            self._handle_pins += len(blocks)
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
        """Admit what fits, then one decode step over every live row, then
        take the queue head's radix match ahead of its admission. Returns
        True if any work was done."""
        with self._mutex:
            if self._closed:
                return False
            progressed = False
            if self._queue and self._free_rows():
                progressed = self._admit_pending()
            live = self._live_rows()
            if live:
                self._decode(live)
                progressed = True
            if self._radix is not None and self._queue:
                self._stage_radix_plan()
            return progressed

    def run_until_idle(self) -> None:
        while not self._closed and (self._queue or self._live_rows()):
            self.step()

    def stream(self, req: Request) -> Iterator[int]:
        """Yield ``req``'s tokens as they are produced, pumping the server."""
        idx = 0
        while True:
            with self._mutex:
                batch, done, error = req.tokens[idx:], req.done, req.error
            yield from batch
            idx += len(batch)
            if done:
                if error is not None:
                    raise RequestFailed(f"request {req.id} failed: {error}") from error
                return
            self.step()

    def result(self, req: Request) -> list:
        """Pump until ``req`` finishes; its generated token ids."""
        return list(self.stream(req))

    def cancel(self, req: Request) -> bool:
        """Cancel a queued or in-flight request; True if it was live. A live
        row's prompt KV is complete, so its blocks go into the prefix cache
        as on a clean finish."""
        with self._mutex:
            if req.done:
                return False
            if req.row is None:
                self._queue.remove(req)
                self._release_staged(req)
            else:
                serve_ops.serve_cancel_rows(self.state, [req.row])
                self._release(req.row, insert=True)
            req.done = True
            req.finished_at = time.perf_counter()
            return True

    def close(self) -> None:
        """Stop accepting work; fail queued and in-flight requests with
        ``ServerClosed``. Idempotent. Their blocks are freed, not cached."""
        with self._mutex:
            if self._closed:
                return
            self._closed = True
            err = ServerClosed("server closed")
            victims = list(self._queue) + [r for r in self._req if r is not None]
            self._queue.clear()
            for r in victims:
                self._release_staged(r)
                if r.row is not None:
                    serve_ops.serve_cancel_rows(self.state, [r.row])
                    self._release(r.row)
                r.error, r.done = err, True

    def arena_bytes(self) -> int:
        """Device bytes of the KV arena and its scale pools."""
        return self._alloc.arena_bytes(
            num_layers=self.cfg.num_hidden_layers, num_kv_heads=self.cfg.num_key_value_heads,
            head_dim=self.cfg.head_dim_, kv_dtype=self.kv_store_dtype,
        )

    # ---------------------------------------------------------- internals

    def _bucket(self, n: int) -> int:
        for b in ADMIT_BUCKETS:
            if b >= n and b <= self.capacity:
                return b
        raise NeverFits(f"prompt length {n} exceeds admit buckets/capacity")

    def _chunked(self, bucket: int) -> bool:
        return self.prefill_chunk is not None and bucket > self.prefill_chunk

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
        pool can ever free: its capacity minus the blocks live handles pin."""
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
            raise ValueError(
                f"prefix rows ({prefix.spx}) + suffix bucket ({bucket}) + max_new "
                f"({max_new}) exceeds server capacity ({self.capacity})"
            )
        total_pos = prefix.n + bucket + max_new
        if total_pos > self.cfg.max_position_embeddings:
            raise ValueError(
                f"requested {total_pos} positions > max_position_embeddings "
                f"({self.cfg.max_position_embeddings})"
            )
        if not prefix.owned_by(self) and prefix.blocks is not None:
            raise ValueError(
                "prefix handle belongs to a different server — its block ids index "
                "that server's KV pool, so mapping them here would corrupt live rows; "
                "prefill_prefix on THIS server"
            )
        if prefix.blocks is None:
            raise ValueError(
                "prefix handle was released (release_prefix) — its shared blocks are "
                "gone; prefill_prefix the prefix again before submitting suffix "
                "requests against it"
            )

    def _free_rows(self) -> list[int]:
        return [i for i, r in enumerate(self._req) if r is None]

    def _live_rows(self, exclude=frozenset()) -> list[int]:
        return [
            i for i, r in enumerate(self._req)
            if r is not None and not self.state.done[i] and i not in exclude
        ]

    def _push_tables(self) -> None:
        self.state.block_tables.copy_(torch.from_numpy(self._tables))
        self._tables_dirty = False

    def _flush_tables(self) -> None:
        if self._tables_dirty:
            self._push_tables()

    # ------------------------------------------------ prefix cache internals

    def _read_arena_blocks(self, blocks) -> tuple:
        return _read_arena_blocks(self.state, blocks)

    def _radix_plan(self, req: Request):
        """The longest usable cached prefix of a queued request, taken
        (pinned, demoted nodes streamed back) as a ``RadixRef``, or None
        (``server.py:3242``). Usable: block-aligned, at least one suffix
        token left, and the layout ``n + bucket(suffix) + max_new`` (+1 if
        the suffix admits chunked) fits the capacity and positions."""
        if self._radix is None or req.prefix is not None:
            return None
        plen = req.prompt_len
        bs = self.kv_block_size
        m = self._radix.match_tokens(req.prompt)
        m = min(m, ((plen - 1) // bs) * bs)

        def usable(n: int) -> bool:
            bucket = self._bucket(plen - n)
            total = n + bucket + req.max_new + (1 if self._chunked(bucket) else 0)
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
        if head.staged_radix is not None or head.prefix is not None:
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
        priv = self._alloc.alloc(need)
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
        finish or a cancel: the prompt's KV is complete) the blocks of the
        block-aligned prompt go into the tree instead; a chunk-admitted
        row's final prompt token entered by the decode path, past the
        bucket, so its cacheable run ends one token early."""
        req = self._req[row]
        priv, shared = self._row_blocks[row], self._row_shared[row]
        rref = self._row_radix[row]
        consumed: set = set()
        if insert and self._radix is not None and req is not None and req.prefix is None:
            bs = self.kv_block_size
            plen = req.prompt_len
            spx_n = rref.n if rref is not None else 0
            chunked = plen > spx_n and self._chunked(self._bucket(plen - spx_n))
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
        self._req[row] = None
        if req is not None:
            req.row = None

    def _admit_pending(self) -> bool:
        """FIFO admission into free rows (``server.py:3954-4048``): the queue
        head, with its radix plan or handle, and the requests right behind
        it that co-admit with it. Without a prefix, co-admission means the
        same prompt bucket; with a radix hit, the same matched prefix, the
        same suffix bucket and a layout that fits; with a handle, the same
        handle. Every request must fit the free blocks, counting the cold
        tree blocks eviction can free."""
        admitted = False
        free = self._free_rows()
        while self._queue and free:
            head = self._queue[0]
            pfx = head.prefix
            if pfx is not None and pfx.blocks is None:
                self._queue.popleft()
                head.error = ValueError(
                    "prefix handle was released while the request was queued — its "
                    "shared KV blocks are gone; prefill_prefix again and resubmit"
                )
                head.done, head.finished_at = True, time.perf_counter()
                continue
            rplan, head.staged_radix = head.staged_radix, None
            if rplan is None:
                rplan = self._radix_plan(head)
            spx_n = 0 if rplan is None else rplan.n
            bucket = self._bucket(head.prompt_len - spx_n)
            # the suffix bucket picks the path (server.py:3921 forces a hit
            # down the chunked path only at cp > 1)
            chunked = pfx is None and self._chunked(bucket)
            spx = pfx.spx if pfx is not None else spx_n
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
                if r.prefix is not pfx:
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
                need = self._blocks_needed(bucket, self._queue[0].max_new, spx, chunked)
                if need > free_left:
                    break
                free_left -= need
                batch.append(self._queue.popleft())
            rows = free[: len(batch)]
            free = free[len(batch):]
            self._admit(batch, rows, bucket, chunked, pfx, rplan)
            admitted = True
        return admitted

    def _admit(self, batch: list, rows: list, bucket: int, chunked: bool,
               pfx: Optional[PrefixHandle], rplan) -> None:
        n = len(batch)
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
        for i, (r, row) in enumerate(zip(batch, rows)):
            # with a radix hit the device sees only the suffix
            sfx = r.prompt[spx_n:]
            prompts[i, : len(sfx)] = sfx
            plen[i], max_new[i], seeds[i] = len(sfx), r.max_new, r.seed
            temps[i], topks[i], topps[i] = r.temperature, r.top_k, r.top_p
            r.row = row
            self._req[row] = r
            self._map_row_blocks(row, bucket, r.max_new, spx, shared, chunked)
            if rplan is not None:
                if i > 0:  # one pin per mapping row; take() pinned the first
                    self._radix.pin(rplan)
                self._row_radix[row] = rplan
            if self._radix is not None and pfx is None:
                self._radix.eligible_tokens += r.prompt_len
                self._radix.hit_tokens += spx_n
        self._push_tables()  # the admission writes exactly the blocks just mapped
        sampling = (seeds, temps, topks, topps)
        if chunked:
            self._admit_chunked(rows, prompts, plen, max_new, sampling, prefix_off=spx_n)
            return
        pkv, pn = None, 0
        if pfx is not None:
            pkv, pn = pfx.kv, pfx.n
        elif rplan is not None:
            pkv = serve_ops.gather_prefix_kv(self.state, rplan.blocks, self.engine.cache_dtype)
            pn = spx_n
        tok0 = serve_ops.serve_admit(
            self.cfg, self.params, self.state, rows, prompts, plen, max_new, *sampling,
            prefix_kv=pkv, prefix_len=pn, prefix_in_arena=rplan is not None,
        )
        for row, t in zip(rows, tok0):
            self._commit(row, int(t))

    def _admit_chunked(self, rows, prompts, plen, max_new, sampling, prefix_off: int = 0) -> None:
        """Bounded chunks with one decode step of the OTHER live rows after
        each, so a long admission never stalls live streams. Each row's
        final prompt token is masked out of the prefill and fed by the
        first decode step instead. ``prefix_off`` > 0 is a radix hit: the
        suffix starts at that position and column, over the matched blocks
        already resident (``server.py:4323-4470``)."""
        n, bucket = prompts.shape
        Sc = self.prefill_chunk
        idx = np.arange(bucket)[None, :]
        positions = np.where(idx < plen[:, None], prefix_off + idx, POS_SENTINEL).astype(np.int32)
        positions[np.arange(n), plen - 1] = POS_SENTINEL
        self._admitting.update(rows)
        try:
            for ci, off in enumerate(range(0, bucket, Sc)):
                self._flush_tables()
                serve_ops.serve_prefill_chunk(
                    self.cfg, self.params, self.state, rows, prompts[:, off : off + Sc],
                    positions[:, off : off + Sc], off, ci == 0, self.attn_backend,
                    prefix_off=prefix_off,
                )
                others = self._live_rows(exclude=self._admitting)
                if others:
                    self._decode(others)
        finally:
            self._admitting.difference_update(rows)
        last_tok = prompts[np.arange(n), plen - 1]
        serve_ops.serve_admit_finish(self.state, rows, last_tok, prefix_off + plen, max_new,
                                     *sampling)

    def _decode(self, rows: list) -> None:
        self._flush_tables()
        toks = serve_ops.serve_step(self.cfg, self.params, self.state, rows, self.attn_backend)
        for row, t in zip(rows, toks):
            self._commit(row, int(t))

    def _commit(self, row: int, t: int) -> None:
        """One generated token → its request; finish the row when the state
        says it is done (its prompt blocks go into the prefix cache)."""
        req = self._req[row]
        req.tokens.append(t)
        now = time.perf_counter()
        if req.first_token_at is None:
            req.first_token_at = now
        if self.state.done[row]:
            req.done = True
            req.finished_at = now
            self._release(row, insert=True)
