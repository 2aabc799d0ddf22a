"""Serve programs over the paged KV arena, through the stage chain: the port
of ``llm_sharding_tpu/parallel/serve.py`` (``ServeState`` ``:71-111``,
``prefix_prefill`` ``:345``, ``gather_prefix_kv`` ``:408``,
``write_arena_blocks`` / ``write_arena_blocks_q`` ``:465`` / ``:483``,
``serve_cancel_rows`` ``:500``, ``serve_admit`` ``:542``,
``serve_prefill_chunk`` ``:861``, ``serve_admit_finish`` ``:1074``,
``serve_chunk`` ``:1198``, ``serve_verify`` ``:1490``), paged and dense.

There is no mesh: a program takes the model as its stage list
(``parallel/pipeline.Stage``; a one-device params dict is one stage) and
runs every live row through stage 0's layers, then stage 1's, and so on,
the hidden state hopping between the stages' devices: one pass per stage
per step. The JAX package's interleaved ring (each stage serving another
slot every microstep) has no counterpart: rows are independent, so the
tokens are the same, and one host thread issuing every launch would pay
each layer's launches once per stage per token. So the in-flight ring
block, its validity bit and the per-slot schedule fields are gone too.
Each admission fills whichever rows are free, and one decode step
advances every live row by one token. Each stage holds its own arena
``[L_stage, NB, BS, Nkv, D]`` (and scales) on its device (``arenas``);
one block table and the row state, on the first stage's device, serve
every stage, as JAX's ``[S, Lp, NB, ...]`` arena shares its tables. The
head is sharded by vocab over the stages (``parallel/head.py``): greedy
ids come from the per-shard maxima, and only a sampled row's logits are
gathered. The model family's functions come from one table
(``parallel/pipeline.model_fns``), so every program serves llama-family
and GPT-2 weights alike, raw or quantized.

Under tensor parallelism a stage's arena is one per shard of its tensor
group: ``Arena.k`` / ``v`` are ``models/stack.HeadShards``, each part
``[L_stage, NB, BS, Nkv / tp, D]`` on its shard's device (JAX ``_kv_spec``
puts the KV heads on the tensor axis, ``serve.py:122-137``), while the
tables and the row state stay once, on the first device. What leaves the
arena (a prefix operand, blocks read for the host tier, a snapshot) is
joined by head into the one-shard layout, and what enters it is split by
head, so host copies do not depend on the tensor degree. A quantized arena
is refused under tensor parallelism, as in JAX.

The arena, the per-column key positions and the per-row state (``tok``,
``pos_slots``, ``write_off``, ``lengths``, ``done``, ``budget``, under the
JAX names) live on the device, and every program reads and advances them
there. ``serve_chunk`` runs ``cycles`` decode steps over all ``M`` rows at
one fixed shape with no host read and no host copy, so a server may
dispatch the next step before it has read the last one's tokens: the
steps chain on the device as one deterministic sequence. Each program
that commits tokens returns them as a log on the device; the host keeps
mirrors (``out``, ``mirror_len``, ``mirror_budget``) that follow as it
applies those logs (``commit_log``, ``commit_verify``), as the JAX server
replays its chunk logs. The sampling settings and each sampled row's
``torch.Generator`` stay on the host: a generator draws at launch.

A quantized arena (``kv_dtype`` int8 / fp8) holds 1-byte codes with
per-(block, KV head) f32 scales, as in the JAX state. The dense prefill of
a one-shot admission still runs in the engine's dtype; its window is
quantized as it is scattered (``scatter_pages_q``). A chunked admission
resets its rows' PRIVATE block scales on the first chunk, and every later
write (chunks, decode) quantizes against the running block absmax
(``ops/paged_attention.write_block_kv``).

Dense mode (``make_state`` without ``kv_block_size``, the JAX ``serve``
default) gives every row its own cache ``[L, M, C, Nkv, D]`` with no
tables and no scales (JAX ``serve.py:253-300``): capacity is per row. A
one-shot admission prefills a fresh ``C``-column cache for its rows
(flash at S = bucket over C) and copies it into their rows; a chunk
prefills the rows' own cache at the chunk's columns (flash again); a
decode step writes each row's entry at its own column, gated by a select
for rows that are done, and attends the row's whole cache on the plain
path (S = 1); a verify runs over every row at S = K + 1 through flash. The
same fixed-shape, sync-free contract holds for ``serve_chunk``.

Context parallelism (``serve(cp=N)``, JAX ``serve.py:122-156``, ``:231-315``)
splits each stage's paged arena by block over a shard group: ``Arena.k`` /
``v`` (and the scales) are ``models/stack.CpShards``, one arena of
``kv_blocks`` blocks per shard on its device, and ``block_tables`` is
``[cp, M, T]``, each shard's plane of LOCAL block ids (the server's host
mirror keeps global ids ``shard * kv_blocks + local`` and projects the
planes when it pushes them; a column another shard owns is the shard's
trash block 0). Every program writes the fresh KV through every shard's
plane, so an owned column lands in a real block and the rest in trash, and
each paged layer attends shard by shard in stats mode and merges the
partials (``models/llama.cp_attn_fn``). The one-shot admission still
prefills once, densely (flash), and scatters the window through each
shard's plane; a chunk is the ring pass of JAX's chunked prefill. What
leaves or enters the arena by block id (snapshots, the host tier, a
hand-off's stream) takes global ids and reads or writes each block on its
owner shard, so host copies do not depend on the shard count.

A prefix (an explicit handle's KV, or a radix-cache hit's blocks) puts a
row's suffix at absolute positions and columns ``prefix + i``. A radix
hit's shared blocks are already in the arena and are never written again
(``prefix_in_arena``, ``prefix_off``): their codes and scales stay
byte-stable under every row that maps them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import hop, to_device
from ..models.cache import POS_SENTINEL, KVCache, block_pool_shape, block_scale_shape
from ..models.config import ModelConfig
from ..models.stack import CpShards, HeadShards, cp_part, full_heads, per_shard
from ..obs.metrics import CANCEL_BATCH_ROWS
from ..ops.paged_attention import _bytes, _take, write_block_kv
from ..ops.quant import is_kv_quantized, kv_dequantize, kv_qmax, kv_quantize, kv_storage_dtype
from ..ops.sampling import filter_rows, gumbel, is_stop, sample
from .head import sp_head
from .pipeline import as_stages, chain_caches, chain_embed, chain_forward, model_fns, run_stages


class Arena(NamedTuple):
    """One stage's KV store on its device."""

    k: torch.Tensor  # paged: [L_stage, NB, BS, Nkv, D] pooled arena, block 0 = trash;
    #   dense: [L_stage, M, C, Nkv, D], one cache row per serving row
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]  # [L_stage, NB, Nkv] f32 of an int8/fp8 arena, else None
    v_scale: Optional[torch.Tensor]


@dataclasses.dataclass
class ServeState:
    """The fields of the JAX ``ServeState``, plus the host's mirrors and
    sampling settings. ``arenas`` holds each stage's KV store in chain
    order; the tables and the row state are on the first stage's device."""

    arenas: list  # [Arena] per stage
    cache_dtype: torch.dtype  # the engine's dtype: dense prefill cache, attention queries
    kpos: torch.Tensor  # [M, W] int32 key position per LOGICAL column
    block_tables: torch.Tensor  # [M, T] int32 (the server owns the host mirror);
    #   dense: an [M, 1] placeholder of trash entries; context-parallel:
    #   [cp, M, T], each shard's plane of local block ids
    # row state on the device, read and advanced by the programs
    tok: torch.Tensor  # [M] int32 next input token of each row
    pos_slots: torch.Tensor  # [M] int32 position of that token
    write_off: torch.Tensor  # [M] int32 logical column its KV lands in
    lengths: torch.Tensor  # [M] int32 valid length (prompt + generated)
    done: torch.Tensor  # [M] bool; free and parked rows are done
    budget: torch.Tensor  # [M] int32 max total length (prompt + max_new)
    row_ids: torch.Tensor  # [M] int64 arange: the programs' row index
    # on the host: what the applied logs say
    out: np.ndarray  # [M, W] int32 prompt + generated tokens
    mirror_len: np.ndarray  # [M] lengths as of the last applied log
    mirror_budget: np.ndarray  # [M] budget as the host armed it
    temp: np.ndarray  # [M] f32 sampling temperature (<= 0 greedy)
    topk: np.ndarray  # [M] int32 (0 off)
    topp: np.ndarray  # [M] f32 (1.0 off)
    rng: list  # [M] per-row torch.Generator of a sampled row, else None
    dense: bool = False  # per-row caches instead of the pooled arena

    @property
    def block_size(self) -> int:
        """The arena's block size; 0 for a dense state."""
        return 0 if self.dense else self.arenas[0].k.shape[2]

    @property
    def device(self) -> torch.device:
        """The first stage's device: the tables and the row state."""
        return self.kpos.device

    def _one(self) -> Arena:
        if len(self.arenas) != 1:
            raise ValueError(
                f"the arena is split over {len(self.arenas)} stages: read state.arenas"
            )
        return self.arenas[0]

    # a one-stage state's arena under the JAX field names
    k = property(lambda self: self._one().k)
    v = property(lambda self: self._one().v)
    k_scale = property(lambda self: self._one().k_scale)
    v_scale = property(lambda self: self._one().v_scale)

    @property
    def rows(self) -> int:
        return self.kpos.shape[0]

    @property
    def cp(self) -> int:
        """The context-parallel degree: the shards each arena is split over."""
        return self.block_tables.shape[0] if self.block_tables.dim() == 3 else 1


def make_state(
    cfg: ModelConfig,
    rows: int,
    *,
    capacity: int,
    kv_blocks: int = 0,
    kv_block_size: int = 0,
    dtype: torch.dtype,
    device: torch.device,
    kv_dtype: str = "bf16",
    stages: Optional[list] = None,  # [(num_layers, devices)] per stage: its tensor group
    cp_groups: Optional[list] = None,  # per stage: its context-parallel shard devices
) -> ServeState:
    """Empty state: every row free (done), every table entry trash. Each
    row's logical window is ``W = ceil(capacity / BS) * BS`` columns.
    ``kv_dtype`` "int8"/"fp8" allocates 1-byte arenas and zero scales;
    "bf16" stores in ``dtype``, the engine's own. ``kv_block_size`` 0 is
    dense: per-row ``[L, M, capacity, Nkv, D]`` caches in ``dtype``, an
    ``[M, 1]`` placeholder table and no scales (``serve.py:253-300``).
    ``stages`` gives each stage's layer count and tensor group, a tuple of
    devices (default: one stage of every layer on ``device``); a group of
    more than one device gets one arena per shard of ``Nkv / tp`` heads,
    as ``HeadShards``. The tables and the row state go on ``device``, the
    first stage's. ``cp_groups`` (paged only, one shard group per stage)
    gives each stage one arena of ``kv_blocks`` blocks (and scales) per
    shard, as ``CpShards``, and ``[cp, M, T]`` tables."""
    dense = not kv_block_size
    if dense and kv_dtype != "bf16":
        raise ValueError(f"kv_dtype={kv_dtype!r} needs a paged arena")
    T = 1 if dense else -(-capacity // kv_block_size)
    W = capacity if dense else T * kv_block_size
    store = kv_storage_dtype(kv_dtype, dtype)
    quantized = is_kv_quantized(store)

    def arena(L, group):
        if dense:
            shape = (L, rows, capacity, cfg.num_key_value_heads, cfg.head_dim_)
        else:
            shape = block_pool_shape(cfg, kv_blocks, kv_block_size, L)
        if len(group) > 1:
            if quantized:
                raise ValueError("a quantized arena is not split over a tensor group")
            shape = shape[:-2] + (shape[-2] // len(group), shape[-1])
            return HeadShards([torch.zeros(shape, dtype=store, device=d) for d in group])
        if quantized:  # zero bytes, viewed: fills of fp8 tensors are not everywhere
            return torch.zeros(shape, dtype=torch.uint8, device=group[0]).view(store)
        return torch.zeros(shape, dtype=store, device=group[0])

    def scales(L, group):
        if not quantized:
            return None
        return torch.zeros(block_scale_shape(cfg, kv_blocks, L), dtype=torch.float32,
                           device=group[0])

    def row_i32():
        return torch.zeros(rows, dtype=torch.int32, device=device)

    stages = stages or [(cfg.num_hidden_layers, (device,))]
    if cp_groups is not None:
        if dense:
            raise ValueError("a context-parallel arena is paged")

        def sharded(make, L, shards):
            parts = [make(L, (d,)) for d in shards]
            return None if parts[0] is None else CpShards(parts, shards)

        arenas = [Arena(*(sharded(f, L, tuple(g)) for f in (arena, arena, scales, scales)))
                  for (L, _), g in zip(stages, cp_groups)]
        tables = (len(cp_groups[0]), rows, T)
    else:
        arenas = [Arena(arena(L, dev), arena(L, dev), scales(L, dev), scales(L, dev))
                  for L, dev in stages]
        tables = (rows, T)
    return ServeState(
        arenas=arenas,
        cache_dtype=dtype,
        kpos=torch.full((rows, W), POS_SENTINEL, dtype=torch.int32, device=device),
        block_tables=torch.zeros(tables, dtype=torch.int32, device=device),
        tok=row_i32(),
        pos_slots=row_i32(),
        write_off=row_i32(),
        lengths=row_i32(),
        done=torch.ones(rows, dtype=torch.bool, device=device),
        budget=row_i32(),
        row_ids=torch.arange(rows, device=device),
        out=np.zeros((rows, W), np.int32),
        mirror_len=np.zeros(rows, np.int64),
        mirror_budget=np.zeros(rows, np.int64),
        temp=np.zeros(rows, np.float32),
        topk=np.zeros(rows, np.int32),
        topp=np.ones(rows, np.float32),
        rng=[None] * rows,
        dense=dense,
    )


def _arm_sampling(state: ServeState, rows, seeds, temps, topks, topps, rng_states=None) -> None:
    """Per-row sampling settings; a sampled row gets its own generator
    seeded with the request's seed, so its draws equal ``generate``'s at
    batch 1. ``rng_states[i]``, where not None, is the generator state a
    migrated request carries (``torch.Generator.get_state()`` bytes, taken
    on a server of the same device type): the row resumes the draws of its
    uninterrupted run instead of restarting them."""
    dev = state.device
    for i, r in enumerate(rows):
        state.temp[r] = max(float(temps[i]), 0.0)
        state.topk[r] = int(topks[i])
        state.topp[r] = float(topps[i])
        state.rng[r] = None
        if state.temp[r] > 0:
            state.rng[r] = torch.Generator(device=dev).manual_seed(int(seeds[i]))
            if rng_states is not None and rng_states[i] is not None:
                state.rng[r].set_state(torch.from_numpy(np.asarray(rng_states[i], np.uint8)))


def _next_tokens(cfg: ModelConfig, stages: list, state: ServeState, rows,
                 h: torch.Tensor) -> torch.Tensor:
    """The next token of each of ``rows`` from the final hidden states ``h
    [n, 1, H]``, on the first stage's device: one stage samples its
    logits (``_sample_rows``); more take the greedy ids from the
    vocab-sharded head, and gather the logits of the rows that sample
    only, which then draw as on one stage."""
    if len(stages) == 1:
        logits = model_fns(cfg).final_logits(cfg, stages[0].head, h)[:, 0]
        return _sample_rows(state, rows, logits)
    samp = [i for i, r in enumerate(rows) if state.rng[r] is not None]
    toks, full = sp_head(cfg, stages, h[:, 0], samp)
    for j, i in enumerate(samp):
        r = rows[i]
        toks[i] = sample(
            full[j : j + 1], float(state.temp[r]), int(state.topk[r]), float(state.topp[r]),
            generator=state.rng[r],
        )[0]
    return toks


def _sample_rows(state: ServeState, rows, logits: torch.Tensor) -> torch.Tensor:
    """One token per row, left on the device: greedy rows by one argmax,
    each row that holds a generator from its own (``logits[i]`` is row
    ``rows[i]``'s). A finished row's generator is dropped, so a row that
    is done draws nothing; one that finished on the device but not yet on
    the host may draw, and its generator no longer matters."""
    toks = logits.argmax(dim=-1).to(torch.int32)
    for i, r in enumerate(rows):
        if state.rng[r] is not None:
            toks[i] = sample(
                logits[i : i + 1], float(state.temp[r]), int(state.topk[r]),
                float(state.topp[r]), generator=state.rng[r],
            )[0]
    return toks


def scatter_pages_q(
    arena: torch.Tensor,  # [NB, BS, Nkv, D] 1-byte codes, written in place
    scale: torch.Tensor,  # [NB, Nkv] f32, written in place
    block_table: torch.Tensor,  # [n, T] the rows' tables
    window: torch.Tensor,  # [n, Sp, Nkv, D] the rows' fresh KV in columns [0, Sp)
) -> None:
    """Quantizing scatter of one layer of a one-shot admission
    (``_scatter_pages_q``, ``serve.py:194-212``): each row's WHOLE logical
    window, ``window`` followed by zeros, lands through its table as codes,
    and every mapped block's scale is RESET to its new content's absmax /
    qmax. Not the running max: a recycled block would keep its previous
    occupant's larger scale and store coarser codes. The trash entries of
    a table receive garbage, as in the JAX program."""
    n, T = block_table.shape
    BS, Nkv, D = arena.shape[1:]
    full = torch.zeros((n, T * BS, Nkv, D), dtype=window.dtype, device=window.device)
    full[:, : window.shape[1]] = window
    vals = full.reshape(n, T, BS, Nkv, D)
    sc = vals.float().abs().amax(dim=(2, 4)) / kv_qmax(arena.dtype)  # [n, T, Nkv]
    codes = kv_quantize(vals, sc[:, :, None, :, None], arena.dtype)
    idx = block_table.long()
    arena.view(torch.uint8)[idx] = codes.view(torch.uint8)
    scale[idx] = sc


def _raw(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes as numpy (on the host): bfloat16 as its ``uint16``
    view, float8_e4m3fn as ``uint8`` (numpy has neither dtype)."""
    # a copy, synchronous: the bytes are final when numpy sees them, and a
    # CPU tensor's later writes do not reach them
    t = t.to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    return t.numpy()


def _from_raw(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """Inverse of ``_raw``: host bytes → a tensor of ``dtype`` on ``device``."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # a memory-mapped disk entry
        a = a.copy()
    if dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16)).to(device).view(torch.bfloat16)
    if dtype == torch.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8)).to(device).view(dtype)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _cat_layers(parts: list, device: torch.device) -> torch.Tensor:
    """Per-stage tensors ``[L_stage, ...]`` as one ``[L, ...]`` on
    ``device`` (one stage: its tensor as it is)."""
    if len(parts) == 1:
        return parts[0]
    return torch.cat([hop(p, device) for p in parts])


def _shard_views(ar: Arena, tbl: torch.Tensor):
    """``(k, v, k_scale, v_scale, table)`` of each shard of stage arena
    ``ar``, ``tbl`` the rows' tables (``[n, T]``, or ``[cp, n, T]`` of a
    context-parallel arena, whose shard ``s`` reads plane ``s``): one entry
    without context parallelism."""
    if not isinstance(ar.k, CpShards):
        return [(ar.k, ar.v, ar.k_scale, ar.v_scale, tbl)]
    return [(ar.k.parts[s], ar.v.parts[s], cp_part(ar.k_scale, s), cp_part(ar.v_scale, s),
             None if tbl is None else tbl[s]) for s in range(len(ar.k))]


def _stage_tables(ar: Arena, tbl: torch.Tensor, device: torch.device):
    """The tables stage arena ``ar`` is read through, on its devices: ``tbl``
    on ``device``, or for a context-parallel arena each shard's plane on
    the shard's device, as ``CpShards``."""
    if not isinstance(ar.k, CpShards):
        return hop(tbl, device)
    return CpShards([hop(tbl[s], d) for s, d in enumerate(ar.k.devices)], ar.k.devices)


def prefix_prefill(
    cfg: ModelConfig,
    model,  # the stage list, or one device's params dict
    prefix: np.ndarray,  # [1, Spx] right-padded prefix ids
    prefix_len: int,  # real prefix length
    dtype: torch.dtype,  # the engine's compute dtype
    device: torch.device,
) -> tuple:
    """Prefill a shared prefix once through the dense layer path (the flash
    kernel) of every stage and return its KV, ``(k [L, 1, Spx, Nkv, D],
    v, pos [1, Spx])`` on ``device`` with the sentinel past
    ``prefix_len``: the handle a ``serve_admit(prefix_kv=)`` seeds its
    rows' caches from (``serve.py:345``)."""
    stages = as_stages(model)
    Spx = prefix.shape[1]
    idx = np.arange(Spx)[None, :]
    positions = np.where(idx < prefix_len, idx, POS_SENTINEL).astype(np.int32)
    pos_t = torch.from_numpy(positions).to(device)
    caches = chain_caches(cfg, stages, 1, Spx, dtype)
    h = chain_embed(cfg, stages, torch.from_numpy(prefix).to(device), pos_t)
    chain_forward(cfg, stages, h, caches, pos_t)
    return (_cat_layers([full_heads(c.k, device) for c in caches], device),
            _cat_layers([full_heads(c.v, device) for c in caches], device), caches[0].pos)


def gather_prefix_kv(state: ServeState, blocks: list, out_dtype: torch.dtype) -> tuple:
    """A radix hit's prefix operand straight from the arenas
    (``serve.py:408``): the ``T`` matched blocks as ``(k [L, 1, T*BS, Nkv,
    D], v, pos [1, T*BS])`` on the first stage's device, no prefill. A
    quantized arena's codes come back dequantized into ``out_dtype``, the
    engine's compute dtype. Matches are block-aligned and gap-free, so
    ``pos`` is ``arange``."""
    dev = state.device
    ks, vs = [], []
    for ar in state.arenas:
        idx = torch.as_tensor(blocks, dtype=torch.long, device=ar.k.device)
        for arena, scale, out in ((ar.k, ar.k_scale, ks), (ar.v, ar.v_scale, vs)):
            g = full_heads(per_shard(_take_blocks, arena, idx))  # [L, T, BS, Nkv, D]
            if scale is not None:
                g = kv_dequantize(g, scale[:, idx][:, :, None, :, None], out_dtype)
            L, T, BS = g.shape[:3]
            out.append(g.reshape(L, 1, T * BS, *g.shape[3:]))
    k, v = _cat_layers(ks, dev), _cat_layers(vs, dev)
    pos = torch.arange(k.shape[2], dtype=torch.int32, device=dev)[None]
    return k, v, pos


def _take_blocks(arena: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Blocks ``idx`` of every layer of one arena (``[L, nb, ...]``)."""
    return _take(arena, (slice(None), idx))


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """A host tensor's bytes as numpy without a copy (``_raw``'s views)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    return t.numpy()


class BlockRead:
    """Arena blocks gathered on the device and on their way to the host
    (the JAX ``_read_arena_blocks_dispatch``'s device arrays,
    ``runtime/server.py:3145``). Building one queues the work and waits for
    none of it: the gathers go on the current stream, behind every program
    already queued there (so they read the bytes those programs wrote, and
    the arena's later writes cannot reach the gathered copies); on the card
    a ``non_blocking`` copy into pinned host buffers follows, then an event.
    ``parts`` are on one device: the stages' gathers are joined there.
    ``numpy()`` waits for that event (releasing the interpreter lock) and
    returns the host bytes: call it outside the server's mutex."""

    __slots__ = ("host", "event")

    def __init__(self, parts: tuple):
        if parts[0].device.type == "cuda":
            self.host = tuple(
                torch.empty(p.shape, dtype=p.dtype, pin_memory=True) for p in parts
            )
            for h, p in zip(self.host, parts):
                h.copy_(p, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:  # the gathers ran in the call: fresh host tensors already
            self.host, self.event = parts, None

    def numpy(self, keep_pinned: bool = True) -> tuple:
        """``read_arena_blocks``'s arrays, once the copy has landed: views
        of the pinned buffers, or with ``keep_pinned=False`` pageable
        copies (what a long-lived holder such as the tree's host tier
        keeps, so pinned memory is not held for the cache's lifetime)."""
        if self.event is None:
            return tuple(_host_bytes(h)[None] for h in self.host)
        self.event.synchronize()
        return tuple(
            _host_bytes(h if keep_pinned else h.clone())[None] for h in self.host
        )


def _by_owner(blocks, per_shard_blocks: int) -> list:
    """Global block ids of a context-parallel arena by owner shard: ``[(s,
    positions in blocks, local ids)]`` for each shard that holds any."""
    g = np.asarray(blocks, np.int64)
    own = g // per_shard_blocks
    return [(int(s), np.nonzero(own == s)[0], g[own == s] % per_shard_blocks)
            for s in np.unique(own)]


def _take_global(a: CpShards, blocks, device: torch.device) -> torch.Tensor:
    """Blocks of global ids ``blocks`` of every layer of a context-parallel
    arena (or scales) ``a``, each read on its owner shard, joined in order
    on ``device``."""
    out = None
    for s, pos, local in _by_owner(blocks, a.shape[1]):
        part = hop(_take_blocks(a.parts[s], to_device(local, a.devices[s])), device)
        if out is None:
            out = torch.empty((part.shape[0], len(blocks)) + tuple(part.shape[2:]),
                              dtype=part.dtype, device=device)
        _bytes(out)[:, to_device(pos, device)] = _bytes(part)
    return out


def read_arena_blocks_dispatch(state: ServeState, blocks: list) -> BlockRead:
    """Queue the gathers of arena blocks and their copy to the host
    (``BlockRead``); the JAX ``runtime/server.py:3145``. Nothing here waits
    for the device: the block ids go up through a pinned staging copy. The
    stages' blocks are joined along the layer axis on the first stage's
    device, so the host arrays are the one-stage layout. A context-parallel
    arena takes global ids and reads each block on its owner shard."""
    per_stage = []
    for ar in state.arenas:
        parts = [ar.k, ar.v] + ([] if ar.k_scale is None else [ar.k_scale, ar.v_scale])
        if isinstance(ar.k, CpShards):
            per_stage.append([_take_global(a, blocks, ar.k.device) for a in parts])
            continue
        idx = to_device(np.asarray(blocks, np.int64), ar.k.device)
        per_stage.append([full_heads(per_shard(_take_blocks, a, idx)) for a in parts])
    return BlockRead(tuple(_cat_layers(list(p), state.device) for p in zip(*per_stage)))


def read_arena_blocks(state: ServeState, blocks: list) -> tuple:
    """Device→host copy of arena blocks (JAX ``runtime/server.py:3176``):
    ``(k, v)`` numpy ``[1, L, nb, BS, Nkv, D]`` in the arena's bytes
    (``_raw``), plus ``(k_scale, v_scale)`` ``[1, L, nb, Nkv]`` f32 for an
    int8/fp8 arena: the dispatch half, then the wait for the copy. The
    copy is complete when this returns; the arrays are pageable."""
    return read_arena_blocks_dispatch(state, blocks).numpy(keep_pinned=False)


def write_arena_blocks(k_arena, v_arena, blocks: list, k_host, v_host) -> None:
    """Host copies (``read_arena_blocks``'s) back into arena blocks, in
    place (``serve.py:465``). Queued on the current stream, so it lands
    before any later program that reads those blocks. Byte-exact."""
    idx = torch.as_tensor(blocks, dtype=torch.long, device=k_arena.device)
    for arena, host in ((k_arena, k_host), (v_arena, v_host)):
        _bytes(arena)[:, idx] = _bytes(_from_raw(host[0], arena.dtype, arena.device))


def write_arena_blocks_q(
    k_arena, v_arena, k_scale, v_scale, blocks: list, k_host, v_host, ks_host, vs_host
) -> None:
    """``write_arena_blocks`` for an int8/fp8 arena (``serve.py:483``): the
    codes and their per-(block, KV head) scales, byte-exact."""
    write_arena_blocks(k_arena, v_arena, blocks, k_host, v_host)
    idx = torch.as_tensor(blocks, dtype=torch.long, device=k_scale.device)
    k_scale[:, idx] = _from_raw(ks_host[0], torch.float32, k_scale.device)
    v_scale[:, idx] = _from_raw(vs_host[0], torch.float32, v_scale.device)


def write_state_blocks(state: ServeState, blocks: list, k_host, v_host, *scales) -> None:
    """Host arrays in the one-stage layout (``read_arena_blocks``'s ``[1,
    L, nb, ...]``) written into every stage's arena, each stage taking its
    layers (each shard of a tensor group its heads, and each block of a
    context-parallel arena, a global id, its owner shard): codes and, for
    an int8/fp8 arena, scales, byte-exact."""
    lo = 0
    for ar in state.arenas:
        hi = lo + ar.k.shape[0]
        cut = [a[:, lo:hi] for a in (k_host, v_host) + tuple(scales)]
        if isinstance(ar.k, CpShards):  # each block onto its owner shard
            for s, pos, local in _by_owner(blocks, ar.k.shape[1]):
                views = _shard_views(ar, None)[s]
                sel = [a[:, :, pos] for a in cut]
                if views[2] is None:
                    write_arena_blocks(views[0], views[1], list(local), *sel)
                else:
                    write_arena_blocks_q(*views[:4], list(local), *sel)
            lo = hi
            continue
        if isinstance(ar.k, HeadShards):
            tp = len(ar.k.parts)
            heads = [np.split(a, tp, axis=-2) for a in cut]
            for j, (kp, vp) in enumerate(zip(ar.k.parts, ar.v.parts)):
                write_arena_blocks(kp, vp, blocks, heads[0][j], heads[1][j])
        elif ar.k_scale is None:
            write_arena_blocks(ar.k, ar.v, blocks, *cut)
        else:
            write_arena_blocks_q(ar.k, ar.v, ar.k_scale, ar.v_scale, blocks, *cut)
        lo = hi


def serve_admit(
    cfg: ModelConfig,
    model,  # the stage list, or one device's params dict
    state: ServeState,
    rows: list,
    prompts: np.ndarray,  # [n, Sp] right-padded (Sp = the admission bucket)
    prompt_len: np.ndarray,  # [n]
    max_new: np.ndarray,  # [n]
    seeds: np.ndarray,
    temps: np.ndarray,
    topks: np.ndarray,
    topps: np.ndarray,
    prefix_kv: Optional[tuple] = None,  # (k, v, pos) of prefix_prefill / gather_prefix_kv
    prefix_len: int = 0,  # real prefix length (positions resume there)
    prefix_in_arena: bool = False,  # the prefix blocks already hold this KV
    rng_states=None,  # per row: a migrated request's generator state, or None
    prompt_embeds=None,  # [n, Sp, H] hidden states: the rows enter as embeddings
) -> torch.Tensor:
    """One-shot admission: prefill the rows' prompts through the dense
    layer path (the flash kernel), scatter the fresh window into the rows'
    blocks (their tables are on the device already), sample each row's
    first token and arm the rows on the device: the token is committed
    there (``lengths`` counts it, ``done`` is set at a stop id or the
    budget) and becomes the row's next input, which the first decode step
    feeds at position ``prompt_len`` into column ``Sp``. Returns those
    tokens ``[n]`` on the device: the host applies them with
    ``commit_log`` once it has read them, whenever that is.

    With ``prefix_kv`` (``Spx`` columns) each row's dense cache is seeded
    with the prefix, the suffix prefills at positions ``prefix_len + i``
    into columns ``Spx + i`` (flash at S = Sp over C = Spx + Sp), and every
    length, position and column counts the prefix. ``out`` columns are
    prefix-inclusive for what a row generates (tok0 at ``prefix_len +
    prompt_len``); the suffix ids sit at ``[0, prompt_len)``
    (``serve.py:748-757``). With ``prefix_in_arena`` (a radix hit: the
    mapped shared blocks already hold the prefix) the scatter skips those
    blocks (``serve.py:715-740``), so a quantized shared block is never
    requantized; an explicit handle's freshly allocated blocks are written
    by every admission that maps them, with the same bytes each time.

    A dense state gets the rows' whole caches: the prefill runs over a
    fresh ``C``-column cache (flash at S = Sp over C, as JAX
    ``serve.py:686-701``), which then replaces the rows' cache rows.
    ``prompt_embeds`` skips the embedding (the privacy entry,
    ``serve.py:611-616``): the rows enter as the given hidden states, and
    ``prompts`` only fills ``out``. Every stage prefills into its own
    fresh cache and scatters its layers into its own arena."""
    stages = as_stages(model)
    dev = state.device
    n, Sp = prompts.shape
    BS = state.block_size
    rows_t = to_device(np.asarray(rows, np.int64), dev)
    Spx = 0 if prefix_kv is None else prefix_kv[0].shape[2]
    pfx = 0 if prefix_kv is None else int(prefix_len)
    idx = np.arange(Sp)[None, :]
    positions = np.where(idx < prompt_len[:, None], pfx + idx, POS_SENTINEL).astype(np.int32)
    pos_t = to_device(positions, dev)
    C = state.kpos.shape[1] if state.dense else Spx + Sp
    caches = chain_caches(cfg, stages, n, C, state.cache_dtype)
    if prefix_kv is not None:
        pk, pv, ppos = prefix_kv
        for st, cache in zip(stages, caches):
            cache.k[:, :, :Spx] = hop(pk[st.start : st.end], st.device).to(state.cache_dtype)
            cache.v[:, :, :Spx] = hop(pv[st.start : st.end], st.device).to(state.cache_dtype)
            cache.pos[:, :Spx] = hop(ppos, st.device)
            cache.length = Spx
    if prompt_embeds is None:
        h = chain_embed(cfg, stages, to_device(prompts, dev), pos_t)
    else:
        h = to_device(prompt_embeds, dev, state.cache_dtype)
    h = chain_forward(cfg, stages, h, caches, pos_t)
    last = to_device(np.asarray(prompt_len, np.int64) - 1, h.device)
    h_last = h[torch.arange(n, device=h.device), last][:, None]
    _arm_sampling(state, rows, seeds, temps, topks, topps, rng_states)
    tok0 = _next_tokens(cfg, stages, state, rows, h_last)
    if state.dense:
        for ar, cache in zip(state.arenas, caches):
            rows_s = hop(rows_t, ar.k.device)
            ar.k[:, rows_s] = cache.k
            ar.v[:, rows_s] = cache.v
        state.kpos[rows_t] = caches[0].pos
        _arm_admitted(cfg, state, rows, rows_t, prompts, tok0, pfx, prompt_len, max_new,
                      Spx + Sp)
        return tok0

    # a radix hit skips the shared prefix blocks: the scatter covers the
    # columns from w0 on, through the table entries from npfx on
    npfx = 0
    if prefix_in_arena and Spx:
        if Spx % BS:
            raise ValueError(
                f"prefix_in_arena needs a block-aligned prefix, got {Spx} tokens at "
                f"block size {BS}"
            )
        npfx = Spx // BS
    w0 = npfx * BS
    tbl = state.block_tables[..., rows_t, :]
    cols = torch.arange(w0, Spx + Sp, device=dev).expand(n, Spx + Sp - w0)
    for ar, cache in zip(state.arenas, caches):
        # context-parallel: every shard takes the window through its own
        # plane (its columns land in its blocks, the rest in its trash)
        for ka, va, ks, vs, tb in _shard_views(ar, tbl):
            d = ka.device
            tbl_s, cols_s = hop(tb, d), hop(cols, d)
            for layer in range(cache.num_layers):
                kw, vw = hop(cache.k[layer][:, w0:], d), hop(cache.v[layer][:, w0:], d)
                if ks is None:
                    per_shard(write_block_kv, ka[layer], va[layer], tbl_s, cols_s, kw, vw)
                    continue
                scatter_pages_q(ka[layer], ks[layer], tbl_s[:, npfx:], kw)
                scatter_pages_q(va[layer], vs[layer], tbl_s[:, npfx:], vw)
    kpos = torch.full((n, state.kpos.shape[1]), POS_SENTINEL, dtype=torch.int32, device=dev)
    kpos[:, : Spx + Sp] = caches[0].pos
    state.kpos[rows_t] = kpos
    _arm_admitted(cfg, state, rows, rows_t, prompts, tok0, pfx, prompt_len, max_new, Spx + Sp)
    return tok0


def _arm_admitted(cfg, state: ServeState, rows, rows_t, prompts, tok0, pfx: int, prompt_len,
                  max_new, write_off: int) -> None:
    """The rows' state on the device after a one-shot admission, the first
    token committed: it is the next input, at position ``pfx +
    prompt_len``, into column ``write_off``."""
    total = pfx + np.asarray(prompt_len, np.int64)
    budget = total + np.asarray(max_new, np.int64)
    rs = to_device(np.stack([total, budget]).astype(np.int32), state.device)
    state.tok[rows_t] = tok0
    state.pos_slots[rows_t] = rs[0]
    state.write_off[rows_t] = write_off
    state.lengths[rows_t] = rs[0] + 1
    state.budget[rows_t] = rs[1]
    state.done[rows_t] = is_stop(cfg, tok0) | (rs[0] + 1 >= rs[1])
    Sp = prompts.shape[1]
    for i, r in enumerate(rows):
        state.out[r] = 0
        state.out[r, :Sp] = prompts[i]
        state.mirror_len[r] = total[i]
        state.mirror_budget[r] = budget[i]


def serve_prefill_chunk(
    cfg: ModelConfig,
    model,  # the stage list, or one device's params dict
    state: ServeState,
    rows: list,
    tokens: np.ndarray,  # [n, Sc] one chunk of the right-padded prompts
    positions: np.ndarray,  # [n, Sc] absolute positions; sentinel past each
    #   prompt and at its final token (that one enters via the first decode)
    chunk_off: int,  # suffix-relative offset of the chunk (its ``out`` column)
    reset: bool,  # first chunk: forget the rows' previous occupants
    backend: str = "auto",  # ops/paged_attention.BACKENDS
    prefix_off: int = 0,  # block-aligned prefix already resident in the
    #   rows' first table entries (a radix hit); the chunk's arena column
    #   is prefix_off + chunk_off
) -> None:
    """One bounded chunk of a chunked admission. The chunk's KV lands in the
    rows' blocks by a block-indexed scatter, then its queries attend every
    written block in place through the chunked-prefill kernel, each row
    bounded by its written frontier, resident prefix included (``nlive``
    blocks cover columns ``[0, prefix_off + chunk_off + Sc)``). The rows
    stay parked (done on the device: decode steps over all rows skip them)
    until ``serve_admit_finish``.

    The first chunk gives the prefix columns their positions (a radix
    match is gap-free, so position = column) and every later column the
    sentinel (``serve.py:958-967``); on a quantized arena it resets the
    scales of the rows' PRIVATE blocks only (``serve.py:974-989``), so a
    previous occupant's larger scale does not coarsen this admission's
    codes while the shared prefix blocks keep theirs: their codes would
    otherwise dequantize to zero under every row that maps them."""
    stages = as_stages(model)
    dev = state.device
    n, Sc = tokens.shape
    if state.dense:
        _dense_prefill_chunk(cfg, stages, state, rows, tokens, positions, chunk_off, reset)
        return
    BS = state.block_size
    rows_t = to_device(np.asarray(rows, np.int64), dev)
    tbl = state.block_tables[..., rows_t, :]
    col0 = prefix_off + chunk_off
    if reset:
        col = torch.arange(state.kpos.shape[1], dtype=torch.int32, device=dev)
        state.kpos[rows_t] = torch.where(col < prefix_off, col, POS_SENTINEL)[None]
        state.out[rows] = 0
        if state.arenas[0].k_scale is not None:
            priv = tbl.long().clone()
            priv[..., : prefix_off // BS] = 0  # shared prefix blocks keep their scales
            for ar in state.arenas:
                for _, _, ks, vs, pv in _shard_views(ar, priv):
                    pv = hop(pv, ks.device)
                    ks[:, pv] = 0.0
                    vs[:, pv] = 0.0
    pos_t = to_device(np.asarray(positions, np.int32), dev)
    kv_pos = state.kpos[rows_t]
    kv_pos[:, col0 : col0 + Sc] = pos_t
    cols = (col0 + torch.arange(Sc, device=dev)).expand(n, Sc)
    nlive = torch.full((n,), -(-(col0 + Sc) // BS), dtype=torch.int32, device=dev)
    fns = model_fns(cfg)

    def stage(i, st, h):
        ar, d = state.arenas[i], st.device
        return fns.stage_paged(
            cfg, st.layers, h, ar.k, ar.v, _stage_tables(ar, tbl, d), hop(cols, d),
            hop(kv_pos, d), hop(pos_t, d), prefill=True, nlive=hop(nlive, d),
            k_scale=ar.k_scale, v_scale=ar.v_scale, backend=backend,
        )

    run_stages(stages, chain_embed(cfg, stages, to_device(tokens, dev), pos_t), stage)
    state.kpos[rows_t] = kv_pos
    state.write_off[rows_t] = col0 + Sc
    state.out[rows, chunk_off : chunk_off + Sc] = tokens


def _dense_prefill_chunk(cfg, stages: list, state: ServeState, rows, tokens, positions,
                         chunk_off: int, reset: bool) -> None:
    """A dense chunk (``serve.py:1009-1030``): the rows' own caches, reset
    to zeros and sentinels on the first chunk, take the chunk at columns
    ``[chunk_off, chunk_off + Sc)`` through the dense layer path (flash at
    S = Sc over the row's C columns), stage by stage."""
    dev = state.device
    Sc = tokens.shape[1]
    idx = to_device(np.asarray(rows, np.int64), dev)
    if reset:
        for ar in state.arenas:
            ar.k[:, hop(idx, ar.k.device)] = 0
            ar.v[:, hop(idx, ar.k.device)] = 0
        state.kpos[idx] = POS_SENTINEL
        state.out[rows] = 0
    # the rows' caches, gathered, take the chunk and go back
    caches = [
        KVCache(k=ar.k[:, hop(idx, ar.k.device)], v=ar.v[:, hop(idx, ar.k.device)],
                pos=hop(state.kpos[idx], ar.k.device), length=chunk_off)
        for ar in state.arenas
    ]
    pos_t = to_device(np.asarray(positions, np.int32), dev)
    chain_forward(cfg, stages, chain_embed(cfg, stages, to_device(tokens, dev), pos_t), caches,
                  pos_t)
    for ar, cache in zip(state.arenas, caches):
        ar.k[:, hop(idx, ar.k.device)] = cache.k
        ar.v[:, hop(idx, ar.k.device)] = cache.v
    state.kpos[idx] = caches[0].pos
    state.write_off[idx] = chunk_off + Sc
    state.out[rows, chunk_off : chunk_off + Sc] = tokens


def serve_admit_finish(
    state: ServeState,
    rows: list,
    last_tok: np.ndarray,  # [n] each row's final real prompt token
    prompt_len: np.ndarray,
    max_new: np.ndarray,
    seeds: np.ndarray,
    temps: np.ndarray,
    topks: np.ndarray,
    topps: np.ndarray,
    rng_states=None,  # per row: a migrated request's generator state, or None
) -> None:
    """Arm chunk-prefilled rows on the device: the final prompt token
    becomes each row's next input at position ``prompt_len - 1``; the
    first decode step computes it and samples the first generated token."""
    dev = state.device
    _arm_sampling(state, rows, seeds, temps, topks, topps, rng_states)
    plen = np.asarray(prompt_len, np.int64)
    budget = plen + np.asarray(max_new, np.int64)
    rs = to_device(np.stack([plen, budget, np.asarray(last_tok, np.int64)]).astype(np.int32), dev)
    rows_t = to_device(np.asarray(rows, np.int64), dev)
    state.pos_slots[rows_t] = rs[0] - 1
    state.lengths[rows_t] = rs[0]
    state.budget[rows_t] = rs[1]
    state.tok[rows_t] = rs[2]
    state.done[rows_t] = rs[0] >= rs[1]
    state.mirror_len[rows] = plen
    state.mirror_budget[rows] = budget


def serve_chunk(
    cfg: ModelConfig, model, state: ServeState, cycles: int = 1, backend: str = "auto"
) -> torch.Tensor:
    """``cycles`` decode steps over all ``M`` rows at one fixed shape (JAX
    ``serve_chunk``, ``serve.py:1198``). Each step feeds every row's next
    token, writes its KV at the row's write column (quantized against the
    running block scale on an int8/fp8 arena), attends the row's blocks
    through the paged decode kernel and samples the next token. A row
    that is ``done`` on the device writes no key position and does not
    advance, and its table reads as all trash for the step: its KV entry
    lands in the trash block, which no reader sees (one select per step
    gates every layer's write, where JAX gates each layer's with
    ``write_valid=advance``, ``serve.py:1330-1337``). A row commits when
    it is not done and under its budget, and is done at a stop id or at its
    budget (the JAX commit rule, ``serve.py:1394-1413``).

    Returns the ``[cycles, M]`` int32 log of committed tokens, -1 where a
    row committed nothing, left on the device. The program reads nothing
    from the host and copies nothing to the device, so the next chunk may
    be dispatched before this one's log is read: chunks chain on the
    device in dispatch order. It writes the arena and the row state in
    place, so it must never be dispatched twice.

    On a dense state each row writes its entry into its own cache at its
    write column, a done row writing back what it read (a select, no
    boolean-mask index), and attends its whole cache row on the plain path
    (JAX's dense decode is plain too, ``ops/flash_attention.py:241-244``).

    Every stage runs its layers over all ``M`` rows in turn, reading the
    one table and ``kpos`` (copied to a stage on another device, never
    through the host), and the head assembles the tokens on the first
    stage's device."""
    stages = as_stages(model)
    dev = state.device
    M, W = state.kpos.shape
    fns = model_fns(cfg)
    ar = state.row_ids
    log = torch.empty((cycles, M), dtype=torch.int32, device=dev)
    for c in range(cycles):
        live = ~state.done
        pos = state.pos_slots
        cols = state.write_off.clamp(max=W - 1)  # a done row may sit at W
        state.kpos[ar, cols] = torch.where(live, pos, state.kpos[ar, cols])
        h = chain_embed(cfg, stages, state.tok[:, None], pos[:, None])
        if state.dense:
            def stage(i, st, h):
                a, d = state.arenas[i], st.device
                return fns.stage_rows(
                    cfg, st.layers, h, a.k, a.v, hop(ar, d)[:, None], hop(cols, d)[:, None],
                    hop(state.kpos, d), hop(pos, d)[:, None], live=hop(live, d),
                )
        else:
            # (every shard's plane, context-parallel)
            tables = torch.where(live[:, None], state.block_tables, 0)
            # the blocks covering each row's written frontier, this entry
            # included; a done row reads none
            nlive = torch.where(live, cols // state.block_size + 1, 0).to(torch.int32)

            def stage(i, st, h):
                a, d = state.arenas[i], st.device
                return fns.stage_paged(
                    cfg, st.layers, h, a.k, a.v, _stage_tables(a, tables, d),
                    hop(cols, d)[:, None],
                    hop(state.kpos, d), hop(pos, d)[:, None], nlive=hop(nlive, d),
                    k_scale=a.k_scale, v_scale=a.v_scale, backend=backend,
                )

        nxt = _next_tokens(cfg, stages, state, range(M), run_stages(stages, h, stage))
        commit = live & (state.lengths < state.budget)
        step = commit.to(torch.int32)
        state.tok.copy_(torch.where(commit, nxt, state.tok))
        state.lengths.add_(step)
        state.done.copy_(state.done | (commit & (is_stop(cfg, nxt) | (state.lengths >= state.budget))))
        adv = live.to(torch.int32)
        state.write_off.add_(adv)
        state.pos_slots.add_(adv)
        log[c] = torch.where(commit, nxt, -1)
    return log


def commit_log(state: ServeState, row: int, run) -> None:
    """The host mirror of tokens a program committed for ``row``, read from
    its log: they enter ``out`` at the mirrored length, which advances.
    The device took the same step when the program ran."""
    n, c = int(state.mirror_len[row]), len(run)
    state.out[row, n : n + c] = run
    state.mirror_len[row] += c


def serve_verify(
    cfg: ModelConfig,
    model,  # the stage list, or one device's params dict
    state: ServeState,
    rows: list,
    draft: np.ndarray,  # [n, K] right-padded n-gram drafts
    draft_len: np.ndarray,  # [n] valid drafts per row
    backend: str = "auto",  # ops/paged_attention.BACKENDS
) -> torch.Tensor:
    """Speculative verify of the live ``rows`` (the paged branch of JAX
    ``serve_verify``, ``serve.py:1490``): one forward over each row's
    pending token and its K drafts at positions ``pos_slots + i``, logits
    at every position, a variable number of tokens committed per row.
    Returns the ``[n, K+1]`` int32 commit log (-1 padded) on the device;
    the row state advances on the device by each row's run, and
    ``commit_verify`` applies the log to the host mirrors once it is read.

    The K + 1 fresh entries are written by ``write_block_kv`` straight into
    each row's columns ``write_off + i`` (no scratch: per-row columns suit
    the block-indexed scatter); columns past the row's mapped blocks land
    in trash block 0. Only positions the row can never commit go there
    (``cap_commits`` bounds a run by the remaining budget), and no query
    that can commit attends them. The queries see the in-flight entries
    through a temporary ``kv_pos`` window, and the decode kernel runs at S =
    K + 1 (``paged_attn_fn(prefill=False)``). Greedy rows accept by leading
    match against the argmax, sampled rows by ``rejection_commit`` with
    draws from the row's own generator, filtered per row by
    ``filter_rows``. Rollback is a position rewind: ``kpos`` keeps each
    row's accepted prefix and the sentinel past it, never a copy. Like
    ``serve_chunk`` it writes the arena and the row state in place, so it
    must never be dispatched twice.

    A dense state verifies every row at one shape (the dense branch, JAX
    ``serve.py:1620-1630``): the rows not in ``rows`` draft nothing and are
    done for the step, each row's K + 1 entries are written at its own
    columns of its cache (the state holds K + 1 columns over the usable
    capacity for those that can never commit), gated for rows that are
    done, and the queries attend the whole cache row through the flash
    kernel at S = K + 1. The log returned is the ``rows``' own."""
    from ..runtime.spec import _leading_true_count, cap_commits, rejection_commit

    if state.cp > 1:  # JAX serve.py:1512-1561 refuses it in the same words
        raise NotImplementedError(
            "serve_verify does not support context-parallel serving (cp > "
            "1): speculative decode commits a VARIABLE number of tokens per "
            "row, and the cross-shard combine for its K+1-position "
            "traversal is not wired — the server gates speculate off under "
            "cp (ROADMAP: cp-aware speculation)"
        )
    stages = as_stages(model)
    dev = state.device
    verified = None
    if state.dense:
        M, K = state.rows, draft.shape[1]
        full, full_len = np.zeros((M, K), np.int32), np.zeros(M, np.int32)
        full[rows], full_len[rows] = draft, draft_len
        verified = np.zeros(M, bool)
        verified[rows] = True
        picked, rows, draft, draft_len = rows, list(range(M)), full, full_len
    n, K = draft.shape
    rows_t = state.row_ids if state.dense else to_device(np.asarray(rows, np.int64), dev)
    iota_t = torch.arange(K + 1, dtype=torch.int32, device=dev)
    W = state.kpos.shape[1]
    pos_t = state.pos_slots[rows_t][:, None] + iota_t
    cols_t = (state.write_off[rows_t][:, None] + iota_t).clamp(0, W - 1)
    draft_t = to_device(np.asarray(draft, np.int32), dev)
    toks = torch.cat([state.tok[rows_t][:, None], draft_t], dim=1)
    rowsel = torch.arange(n, device=dev)[:, None]
    kv_pos = state.kpos[rows_t]
    kv_pos[rowsel, cols_t] = pos_t  # the in-flight entries, this step only
    lengths, budget, done = state.lengths[rows_t], state.budget[rows_t], state.done[rows_t]
    fns = model_fns(cfg)
    h = chain_embed(cfg, stages, toks, pos_t)
    if state.dense:
        done = done | ~to_device(verified, dev)
        live = ~done

        def stage(i, st, h):
            a, d = state.arenas[i], st.device
            return fns.stage_rows(
                cfg, st.layers, h, a.k, a.v, hop(rowsel, d), hop(cols_t, d), hop(kv_pos, d),
                hop(pos_t, d), live=hop(live, d),
            )
    else:
        tables = state.block_tables[rows_t]
        # the blocks covering each row's written frontier, the K + 1 entries included
        nlive = (cols_t[:, -1] // state.block_size + 1).to(torch.int32)

        def stage(i, st, h):
            a, d = state.arenas[i], st.device
            return fns.stage_paged(
                cfg, st.layers, h, a.k, a.v, hop(tables, d), hop(cols_t, d), hop(kv_pos, d),
                hop(pos_t, d), nlive=hop(nlive, d), k_scale=a.k_scale, v_scale=a.v_scale,
                backend=backend,
            )

    h = run_stages(stages, h, stage)
    samp = [i for i, r in enumerate(rows) if state.rng[r] is not None]
    if len(stages) == 1:
        logits = fns.final_logits(cfg, stages[0].head, h).float()  # [n, K+1, V]
        choices = logits.argmax(dim=-1).to(torch.int32)
    else:  # the vocab-sharded head: greedy ids, the sampled rows' logits gathered
        choices, samp_logits = sp_head(cfg, stages, h, samp)

    valid = to_device(np.arange(K)[None, :] < np.asarray(draft_len)[:, None], dev)
    a = _leading_true_count((choices[:, :K] == draft_t) & valid)
    commit = choices
    if samp:
        sel = to_device(np.asarray(samp, np.int64), dev)
        if len(stages) == 1:
            samp_logits = logits[sel]
        rs = [rows[i] for i in samp]
        knobs = to_device(np.stack([state.temp[rs], state.topp[rs]]).astype(np.float32), dev)
        scaled = filter_rows(
            samp_logits / knobs[0][:, None, None], to_device(state.topk[rs], dev), knobs[1],
        )
        V = samp_logits.shape[-1]
        u = torch.stack([torch.rand(K, generator=state.rng[r], device=dev) for r in rs])
        g = torch.stack([gumbel((K + 1, V), state.rng[r], dev) for r in rs])
        a_s, commit_s = rejection_commit(scaled, draft_t[sel], valid[sel], u, g)
        a = a.clone()
        a[sel] = a_s.to(a.dtype)
        commit = commit.clone()
        commit[sel] = commit_s
    c, log, eos = cap_commits(cfg, commit, a, budget - lengths, done)
    c = c.to(torch.int32)
    kept = torch.where(iota_t[None, :] < c[:, None], pos_t, POS_SENTINEL)
    kv_pos[rowsel, cols_t] = kept
    state.kpos[rows_t] = kv_pos
    # the rows advance by their runs; the run's last token is the next input
    last = torch.gather(log, 1, (c - 1).clamp(min=0).long()[:, None])[:, 0]
    state.tok[rows_t] = torch.where(c > 0, last, state.tok[rows_t])
    state.pos_slots[rows_t] = state.pos_slots[rows_t] + c
    state.write_off[rows_t] = state.write_off[rows_t] + c
    state.lengths[rows_t] = lengths + c
    state.done[rows_t] = state.done[rows_t] | eos | (lengths + c >= budget)
    if verified is not None:
        return log.index_select(0, to_device(np.asarray(picked, np.int64), dev))
    return log


def commit_verify(cfg: ModelConfig, state: ServeState, rows: list, log: np.ndarray) -> None:
    """Apply a ``serve_verify`` log read to the host: each row's committed
    run (``c`` tokens) enters its ``out`` buffer and advances its mirrored
    length (``serve.py:1707-1802``); the device advanced the row when the
    verify ran."""
    for i, r in enumerate(rows):
        run = log[i][log[i] >= 0]
        if run.shape[0]:
            commit_log(state, r, run)


def serve_cancel_rows(state: ServeState, rows: list) -> None:
    """Stop rows (``serve.py:500``): they are done on the device before the
    next program runs, so they take no further decode steps and commit
    nothing; their generators are dropped. One call per batch of rows,
    observed in ``server_cancel_batch_rows`` (``serve.py:514-528``)."""
    rows = list(rows)
    CANCEL_BATCH_ROWS.observe(len(rows))
    mask = np.zeros(state.rows, bool)
    mask[rows] = True
    state.done |= to_device(mask, state.done.device)
    for r in rows:
        state.rng[r] = None
