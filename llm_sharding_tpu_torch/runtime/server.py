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

Not in this slice: dense serving, the prefix cache, speculation, faults,
deadlines, snapshots, metrics and traces.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Iterator, Optional

import numpy as np
import torch

from ..models.cache import POS_SENTINEL
from ..ops.quant import KV_DTYPES, fp8_kv_supported, kv_storage_dtype
from ..ops.sampling import validate_top_p
from ..parallel import serve as serve_ops
from .blocks import BlockAllocator

logger = logging.getLogger(__name__)

# Admission prompt buckets (``server.py:317``).
ADMIT_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768)


class NeverFits(ValueError):
    """The request can never be admitted: its prompt bucket plus budget
    exceeds the server's capacity or position limit, or it needs more KV
    blocks than the pool holds."""


class ServerClosed(RuntimeError):
    """The server was closed."""


class RequestFailed(RuntimeError):
    """The request did not finish (its cause is chained)."""


class Request:
    """A queued or in-flight generation request."""

    def __init__(self, rid: int, prompt: np.ndarray, max_new: int, temperature: float,
                 seed: int, top_k: int, top_p: float):
        self.id = rid
        self.prompt = prompt
        self.prompt_len = int(prompt.shape[0])
        self.max_new = max_new
        self.temperature = temperature
        self.seed = seed
        self.top_k = top_k
        self.top_p = top_p
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
        self.state = serve_ops.make_state(
            self.cfg, self.rows, capacity=self.capacity, kv_blocks=self.kv_blocks,
            kv_block_size=self.kv_block_size, dtype=engine.cache_dtype, device=engine.device,
            kv_dtype=kv_dtype,
        )
        # host mirror of the device block tables; pushed before each dispatch
        # that reads them once a release or a mapping edited it
        self._tables = np.zeros(tuple(self.state.block_tables.shape), np.int32)
        self._tables_dirty = False
        self._row_blocks: list[list[int]] = [[] for _ in range(self.rows)]
        self._req: list[Optional[Request]] = [None] * self.rows
        self._admitting: set[int] = set()
        self._queue: collections.deque[Request] = collections.deque()
        self._next_id = 0
        self._closed = False
        self._mutex = threading.RLock()

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
    ) -> Request:
        """Enqueue a request; it is admitted by a later ``step``. Raises
        ``NeverFits`` for a request no amount of waiting could admit and
        ``ServerClosed`` after ``close``."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if prompt.shape[0] < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        top_p = validate_top_p(top_p)
        bucket = self._bucket(prompt.shape[0])
        chunked = self._chunked(bucket)
        total = bucket + max_new_tokens + (1 if chunked else 0)
        if total > self.capacity or total > self.cfg.max_position_embeddings:
            raise NeverFits(
                f"prompt bucket ({bucket}) + max_new ({max_new_tokens}) needs {total} "
                f"columns; capacity is {self.capacity}, max positions "
                f"{self.cfg.max_position_embeddings}"
            )
        need = self._blocks_needed(bucket, max_new_tokens, chunked)
        if need > self._alloc.capacity_blocks:
            raise NeverFits(
                f"request needs {need} KV blocks but the pool holds "
                f"{self._alloc.capacity_blocks} ({self.kv_blocks} blocks x "
                f"{self.kv_block_size}); raise kv_blocks or lower max_new_tokens"
            )
        with self._mutex:
            if self._closed:
                raise ServerClosed("server is closed; submit rejected")
            req = Request(self._next_id, prompt, int(max_new_tokens), float(temperature),
                          int(seed), int(top_k), top_p)
            self._next_id += 1
            self._queue.append(req)
        return req

    def step(self) -> bool:
        """Admit what fits, then one decode step over every live row.
        Returns True if any work was done."""
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
        """Cancel a queued or in-flight request; True if it was live."""
        with self._mutex:
            if req.done:
                return False
            if req.row is None:
                self._queue.remove(req)
            else:
                serve_ops.serve_cancel_rows(self.state, [req.row])
                self._release(req.row)
            req.done = True
            req.finished_at = time.perf_counter()
            return True

    def close(self) -> None:
        """Stop accepting work; fail queued and in-flight requests with
        ``ServerClosed``. Idempotent."""
        with self._mutex:
            if self._closed:
                return
            self._closed = True
            err = ServerClosed("server closed")
            victims = list(self._queue) + [r for r in self._req if r is not None]
            self._queue.clear()
            for r in victims:
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

    def _blocks_needed(self, bucket: int, max_new: int, chunked: bool) -> int:
        """Blocks covering prompt bucket + budget (+1 column for the chunked
        path's injected final prompt token): every column the row can write."""
        cover = bucket + max_new + (1 if chunked else 0)
        return -(-cover // self.kv_block_size)

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

    def _release(self, row: int) -> None:
        """Remap the row's table to trash, then free its blocks."""
        self._tables[row] = 0
        self._tables_dirty = True
        self._alloc.free(self._row_blocks[row])
        self._row_blocks[row] = []
        req = self._req[row]
        self._req[row] = None
        if req is not None:
            req.row = None

    def _admit_pending(self) -> bool:
        """FIFO admission into free rows: the queue head and the requests
        right behind it that share its bucket and fit the free blocks."""
        admitted = False
        free = self._free_rows()
        while self._queue and free:
            head = self._queue[0]
            bucket = self._bucket(head.prompt_len)
            chunked = self._chunked(bucket)
            free_blocks = self._alloc.num_free
            batch = []
            while self._queue and len(batch) < len(free):
                r = self._queue[0]
                if self._bucket(r.prompt_len) != bucket:
                    break
                need = self._blocks_needed(bucket, r.max_new, chunked)
                if need > free_blocks:
                    break
                free_blocks -= need
                batch.append(self._queue.popleft())
            if not batch:
                logger.info("admission waits: request %d needs more KV blocks "
                            "than the %d free", head.id, self._alloc.num_free)
                break
            rows = free[: len(batch)]
            free = free[len(batch):]
            self._admit(batch, rows, bucket, chunked)
            admitted = True
        return admitted

    def _admit(self, batch: list, rows: list, bucket: int, chunked: bool) -> None:
        n = len(batch)
        prompts = np.zeros((n, bucket), np.int32)
        plen = np.zeros(n, np.int64)
        max_new = np.zeros(n, np.int64)
        seeds = np.zeros(n, np.int64)
        temps = np.zeros(n, np.float32)
        topks = np.zeros(n, np.int32)
        topps = np.ones(n, np.float32)
        for i, (r, row) in enumerate(zip(batch, rows)):
            prompts[i, : r.prompt_len] = r.prompt
            plen[i], max_new[i], seeds[i] = r.prompt_len, r.max_new, r.seed
            temps[i], topks[i], topps[i] = r.temperature, r.top_k, r.top_p
            r.row = row
            self._req[row] = r
            blocks = self._alloc.alloc(self._blocks_needed(bucket, r.max_new, chunked))
            self._row_blocks[row] = blocks
            self._tables[row, : len(blocks)] = blocks  # the rest of a free row is trash
        self._push_tables()  # the admission writes exactly the blocks just mapped
        sampling = (seeds, temps, topks, topps)
        if chunked:
            self._admit_chunked(rows, prompts, plen, max_new, sampling)
            return
        tok0 = serve_ops.serve_admit(
            self.cfg, self.params, self.state, rows, prompts, plen, max_new, *sampling
        )
        for row, t in zip(rows, tok0):
            self._commit(row, int(t))

    def _admit_chunked(self, rows, prompts, plen, max_new, sampling) -> None:
        """Bounded chunks with one decode step of the OTHER live rows after
        each, so a long admission never stalls live streams. Each row's
        final prompt token is masked out of the prefill and fed by the
        first decode step instead."""
        n, bucket = prompts.shape
        Sc = self.prefill_chunk
        idx = np.arange(bucket)[None, :]
        positions = np.where(idx < plen[:, None], idx, POS_SENTINEL).astype(np.int32)
        positions[np.arange(n), plen - 1] = POS_SENTINEL
        self._admitting.update(rows)
        try:
            for ci, off in enumerate(range(0, bucket, Sc)):
                self._flush_tables()
                serve_ops.serve_prefill_chunk(
                    self.cfg, self.params, self.state, rows, prompts[:, off : off + Sc],
                    positions[:, off : off + Sc], off, ci == 0, self.attn_backend,
                )
                others = self._live_rows(exclude=self._admitting)
                if others:
                    self._decode(others)
        finally:
            self._admitting.difference_update(rows)
        last_tok = prompts[np.arange(n), plen - 1]
        serve_ops.serve_admit_finish(self.state, rows, last_tok, plen, max_new, *sampling)

    def _decode(self, rows: list) -> None:
        self._flush_tables()
        toks = serve_ops.serve_step(self.cfg, self.params, self.state, rows, self.attn_backend)
        for row, t in zip(rows, toks):
            self._commit(row, int(t))

    def _commit(self, row: int, t: int) -> None:
        """One generated token → its request; finish the row when the state
        says it is done."""
        req = self._req[row]
        req.tokens.append(t)
        now = time.perf_counter()
        if req.first_token_at is None:
            req.first_token_at = now
        if self.state.done[row]:
            req.done = True
            req.finished_at = now
            self._release(row)
