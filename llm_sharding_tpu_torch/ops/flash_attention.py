"""Dense causal flash attention for prefill (kernel 3), and the
prefill/step attention dispatch.

Counterpart of ``llm_sharding_tpu/ops/flash_attention.py``: the TPU kernel
``flash_attention`` (``:124``, body ``_flash_kernel`` at ``:63``) becomes
``csrc/flash_attention.cu``, and ``attention_prefill`` / ``attention_step``
(``:201-245``) keep their roles. The plain version is
``ops/attention.cached_attention``: same position mask, same fp32
softmax, same ``-1e30`` masking, so a row with no visible key gives the
same uniform average on both (callers discard such rows).

The kernel takes one of three routes, from shapes alone (``flash_route``):
``"heads"`` (bf16, 128 rows of one query head per CTA, ``wgmma`` fed by
TMA), ``"fold"`` (bf16 with ``G * S <= 64`` over a cache of more than a
few tiles: all folded rows of a KV head in one CTA, each K/V tile read
once per KV head) and ``"f32"`` (f32
queries on the tensor cores as 3xTF32 products; plain TF32 would not keep
f32's digits). The bf16 routes split a row tile's visible key tiles over
several CTAs when the row tiles alone leave SMs idle and merge the pieces
in the same launch; ``plan_flash`` is the launch's shape-only plan and
``flash_unit_pieces`` the partition every CTA computes on the card from
the positions. What bounds each route on the H100, and what its design
does about it: the notes in ``csrc/flash_attention.cu``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from . import kernels
from .attention import cached_attention

FLASH_TILE_COLS = 64  # keys per tile of the bf16 routes
FLASH_HEAD_ROWS = 128  # query rows of a "heads" CTA
FLASH_FOLD_ROWS = 64  # folded rows a "fold" CTA holds (its warpgroup's)
FLASH_MAX_TILES = 1024  # tiles whose positions a CTA keeps; later tiles count as visible
FLASH_MAX_ROW_TILES = 256  # row tiles a split plan spans
FLASH_MAX_PIECES = 128  # CTAs per unit of a split (the merge's weights fit the ring)


def flash_min_tiles(D: int) -> int:
    """Tiles below which a split does not pay: a cache of at most this many
    key tiles is neither split nor scanned for visible tiles (its heaviest
    row tile walks every tile anyway), and no run is much shorter. A run's
    partial write and its share of the merge cost a few tiles' walk: 8
    tiles, 4 at head dim 256 (a tile costs twice as much)."""
    return 4 if D == 256 else 8


def flash_route(dtype: torch.dtype, S: int, C: int, Nh: int, Nkv: int, D: int) -> str:
    """The kernel's route for these shapes: ``"f32"`` for f32 queries,
    ``"fold"`` for bf16 when a KV head's folded rows ``G * S`` fit one
    64-row warpgroup and the cache has more than ``flash_min_tiles(D)`` key
    tiles (a smaller one costs each query head a few L2 reads, and a CTA per
    head keeps more in flight), else ``"heads"``."""
    if dtype != torch.bfloat16:
        return "f32"
    big = -(-C // FLASH_TILE_COLS) > flash_min_tiles(D)
    return "fold" if (Nh // Nkv) * S <= FLASH_FOLD_ROWS and big else "heads"


def flash_f32_geometry(D: int) -> tuple[int, int]:
    """Rows of an ``"f32"`` CTA and keys of its tiles: (128, 64), (64, 32)
    at head dim 256 (what fits the shared memory)."""
    return (64, 32) if D == 256 else (128, 64)


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """The kernel's launch, from shapes alone: grid ``(pieces, units, B)``
    with ``units`` query heads (``"heads"``) or KV heads; each unit's query
    rows form ``row_tiles`` tiles of ``rows``; keys come in tiles of
    ``tile_cols``. ``pieces > row_tiles`` is a split: each CTA takes one run
    of a row tile's visible tiles (``flash_unit_pieces``), partials go to
    an f32 scratch and the last run of a row tile merges them."""

    route: str
    pieces: int
    units: int
    row_tiles: int
    rows: int
    tile_cols: int
    min_tiles: int

    @property
    def split(self) -> bool:
        return self.pieces > self.row_tiles

    def scratch_floats(self, B: int, D: int) -> int:
        # a slot per CTA: acc [rows][D], then (m, l) [rows][2]
        return B * self.units * self.pieces * self.rows * (D + 2) if self.split else 0

    def ticket_count(self, B: int) -> int:
        return B * self.units * self.row_tiles if self.split else 0


@functools.lru_cache(maxsize=None)
def plan_flash(
    B: int, S: int, C: int, Nh: int, Nkv: int, D: int, dtype: torch.dtype, sm_count: int
) -> FlashPlan:
    """Launch plan of the flash kernel. ``"heads"``: a CTA per 128-row tile
    of each query head, and when those leave SMs idle, ``sm_count // (B *
    Nh)`` CTAs per head (at most one per tile of each row tile).
    ``"fold"``: ``per_sm * sm_count // (B * Nkv)`` CTAs per KV head (two
    folded CTAs share an SM at head dim <= 128), at most one per key tile.
    Neither splits a cache of at most ``flash_min_tiles(D)`` tiles, and
    neither more than ``FLASH_MAX_PIECES`` ways. ``"f32"``: a CTA per row
    tile of the folded rows, no split."""
    route = flash_route(dtype, S, C, Nh, Nkv, D)
    G = Nh // Nkv
    ntiles = -(-C // FLASH_TILE_COLS)
    min_tiles = flash_min_tiles(D)
    if route == "f32":
        rows, tc = flash_f32_geometry(D)
        R = -(-(G * S) // rows)
        return FlashPlan(route, R, Nkv, R, rows, tc, min_tiles)
    splittable = ntiles > min_tiles
    if route == "fold":
        per_sm = 2 if D <= 128 else 1
        pieces = 1
        if splittable:
            pieces = max(1, min(per_sm * sm_count // (B * Nkv), ntiles, FLASH_MAX_PIECES))
        return FlashPlan(route, pieces, Nkv, 1, FLASH_FOLD_ROWS, FLASH_TILE_COLS, min_tiles)
    R = -(-S // FLASH_HEAD_ROWS)
    pieces = R
    if splittable and B * Nh * R < sm_count and R <= FLASH_MAX_ROW_TILES:
        pieces = max(R, min(sm_count // (B * Nh), R * ntiles, FLASH_MAX_PIECES))
    return FlashPlan(route, pieces, Nh, R, FLASH_HEAD_ROWS, FLASH_TILE_COLS, min_tiles)


@dataclasses.dataclass(frozen=True)
class FlashPiece:
    """One CTA's work in a unit: row tile ``r``, the key tiles it walks
    (in column order), and its place among the row tile's runs: runs
    ``first .. first + nparts - 1`` are consecutive CTAs."""

    r: int
    tiles: tuple
    first: int
    nparts: int


def flash_piece_len(counts, pieces: int, min_tiles: int) -> int:
    """The run length of a split: the least ``L >= min_tiles`` (and >=
    ``ceil(sum / pieces)``) with ``sum ceil(n / L) <= pieces`` over the row
    tiles' visible counts, by bisection as the kernel finds it; a row
    tile of ``n`` visible tiles is then cut into ``ceil(n / L)`` runs of
    as equal length as whole tiles allow."""
    ntot, nmax = sum(counts), max([1, *counts])

    def runs(L):
        return sum(-(-n // L) for n in counts)

    L = max(min_tiles, -(-ntot // pieces))
    if L < nmax and runs(L) > pieces:
        lo, hi = L, nmax
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if runs(mid) <= pieces:
                hi = mid
            else:
                lo = mid
        L = hi
    return L


def flash_row_positions(plan: FlashPlan, S: int, G: int, qpos_row, r: int) -> np.ndarray:
    """Query positions of row tile ``r`` of a unit: positions ``128 r ..``
    (``"heads"``), every position (``"fold"``), or folded rows ``r * rows
    ..`` with row ``g * S + s`` at position ``s`` (``"f32"``)."""
    q = np.asarray(qpos_row, np.int64)
    if plan.route == "heads":
        return q[r * plan.rows : (r + 1) * plan.rows]
    if plan.route == "fold":
        return q
    fr = np.arange(r * plan.rows, min(G * S, (r + 1) * plan.rows))
    return q[fr % S]


def flash_visible_tiles(plan: FlashPlan, qpos_rows, kvpos_row) -> list:
    """The key tiles a row tile with query positions ``qpos_rows`` walks,
    as the kernel finds them: every tile of a cache of at most
    ``plan.min_tiles`` tiles (unless split) or when some row sees no key,
    else each tile whose least position is at most the rows' greatest
    (tiles past ``FLASH_MAX_TILES`` always). The producer may still leave
    out a tile no row sees once every row has seen a key: it would add
    exactly zero."""
    kv = np.asarray(kvpos_row, np.int64)
    tc = plan.tile_cols
    ntiles = -(-len(kv) // tc)
    if (ntiles <= plan.min_tiles and not plan.split) or np.min(qpos_rows) < kv.min():
        return list(range(ntiles))
    qmax = np.max(qpos_rows)
    return [t for t in range(ntiles)
            if t >= FLASH_MAX_TILES or kv[t * tc : (t + 1) * tc].min() <= qmax]


def flash_unit_pieces(plan: FlashPlan, S: int, G: int, qpos_row, kvpos_row) -> list:
    """The partition of one (batch row, unit) as its CTAs compute it on the
    card: per CTA ``j`` of the unit a ``FlashPiece``, or None for an idle
    CTA. Without a split CTA ``j`` walks all of row tile ``R - 1 - j``'s
    visible tiles; with one, row tile ``r``'s ``n`` visible tiles are cut
    into ``p = ceil(n / flash_piece_len(...))`` runs, run ``i`` holding
    tiles ``[i n / p, (i + 1) n / p)``, numbered row tile by row tile."""
    R = plan.row_tiles
    vis = [flash_visible_tiles(plan, flash_row_positions(plan, S, G, qpos_row, r), kvpos_row)
           for r in range(R)]
    if not plan.split:
        return [FlashPiece(R - 1 - j, tuple(vis[R - 1 - j]), 0, 1) for j in range(plan.pieces)]
    L = flash_piece_len([len(v) for v in vis], plan.pieces, plan.min_tiles)
    out = []
    for r, v in enumerate(vis):
        first, n = len(out), len(v)
        p = -(-n // L)
        out += [FlashPiece(r, tuple(v[i * n // p : (i + 1) * n // p]), first, p) for i in range(p)]
    return out + [None] * (plan.pieces - len(out))


def flash_attention(
    q: torch.Tensor,  # [B, S, Nh, D] (RoPE'd)
    k_cache: torch.Tensor,  # [B, C, Nkv, D], keys already written
    v_cache: torch.Tensor,  # [B, C, Nkv, D]
    q_positions: torch.Tensor,  # [B, S] int32
    kv_positions: torch.Tensor,  # [B, C] int32
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal attention over the cache. A CPU tensor runs the plain version;
    a CUDA tensor launches ``csrc/flash_attention.cu`` (one launch; the
    split's scratch and tickets come from here) or raises."""
    if q.device.type == "cpu":
        return cached_attention(q, k_cache, v_cache, q_positions, kv_positions, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    B, S, Nh, D = q.shape
    C, Nkv = k_cache.shape[1], k_cache.shape[2]
    if scale is None:
        scale = D ** -0.5
    code = kernels.check_attention_inputs(q, k_cache, v_cache)
    if k_cache.shape[0] != B:
        raise ValueError(f"k_cache batch {k_cache.shape[0]} != q batch {B}")
    if C < 1:
        raise ValueError("flash_attention needs at least one key column")
    qpos = kernels.int32_operand("q_positions", q_positions, (B, S), q.device)
    kvpos = kernels.int32_operand("kv_positions", kv_positions, (B, C), q.device)
    plan = plan_flash(B, S, C, Nh, Nkv, D, q.dtype, kernels.sm_count(q.device))
    out = torch.empty_like(q)
    # a split's f32 partials: held until the launch is queued, so the
    # allocator cannot hand their memory to anything the launch writes
    part = tickets = None
    if plan.split:
        part = torch.empty(plan.scratch_floats(B, D), dtype=torch.float32, device=q.device)
        tickets = kernels.FLASH.tickets(q.device, plan.ticket_count(B))
    kernels.FLASH.launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), qpos.data_ptr(),
        kvpos.data_ptr(), out.data_ptr(), 0 if part is None else part.data_ptr(),
        0 if tickets is None else tickets.data_ptr(), B, S, C, Nh, Nkv, D, plan.pieces,
        plan.min_tiles, float(scale), code, kernels.current_stream_handle(q.device),
    )
    return out


def attention_prefill(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Prefill-shaped queries (S > 1) take the flash kernel; S == 1 the
    plain path (score-tensor-free at one query already)."""
    if q.shape[1] > 1:
        return flash_attention(q, k_cache, v_cache, q_positions, kv_positions, scale)
    return cached_attention(q, k_cache, v_cache, q_positions, kv_positions, scale)


# The JAX package's ``attention_step`` (``:224``) is the same dispatch plus
# an unused write offset; the dense decoder layer calls it by this name.
attention_step = attention_prefill
