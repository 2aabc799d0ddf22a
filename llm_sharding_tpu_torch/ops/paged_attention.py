"""Attention over the pooled paged KV arena: the decode kernel (kernel 1)
and the chunked-prefill kernel (kernel 2), unquantized and quantized.

Counterpart of ``llm_sharding_tpu/ops/paged_attention.py``:

- ``gather_block_kv`` (``:133``) and ``write_block_kv`` (``:172``, both
  branches, with entry-granular ``valid`` that never reads the device);
- ``paged_attention_xla`` (``:264``), the plain version of both kernels
  in both modes: gather (dequantizing a quantized arena into the query
  dtype), then ``cached_attention``;
- ``attn_stats_xla`` (``:284``) and ``combine_attn_stats`` (``:349``) as
  ``attn_stats`` and ``combine_attn_stats``, the latter over a leading
  split axis: the plain form of the decode kernel's split-KV merge;
- ``paged_attention`` → ``csrc/paged_attention.cu``, the port of
  ``paged_attention_tpu`` (``:484``, body ``_paged_kernel`` at ``:404``):
  one CTA holds every folded query row of its KV head, and the live tiles
  of all rows (each row's ``nlive`` blocks) are cut into equal pieces on
  the card (``plan_decode`` sizes the grid from shapes alone;
  ``decode_pieces`` is the same partition in Python), whose partials the
  last piece of each (row, KV head) merges in the same launch;
- ``paged_prefill`` → ``csrc/paged_prefill.cu``, the port of
  ``paged_prefill_tpu`` (``:689``, body ``_paged_prefill_kernel`` at
  ``:619``): bf16 queries at block sizes 16, 32 or a multiple of 64 run
  on the tensor cores (``prefill_design``), each row's live columns cut
  into runs when the chunk's CTAs fall short of the SMs
  (``plan_prefill_splits``, ``prefill_run_cols``) and merged by a second,
  dependent launch; f32 queries and other block sizes run on the CUDA-core
  tile.

The arena is ``[NB, BS, Nkv, D]``, the block table ``[B, T]`` (entry 0
is the reserved trash block, which reads as zeros everywhere), and
``kv_positions`` is per LOGICAL column ``[B, T * BS]``: column ``c`` of
row ``b`` lives in arena block ``table[b, c // BS]`` at slot ``c % BS``.
A quantized arena holds int8 or fp8-e4m3 codes with per-(block, KV head)
f32 scales ``k_scale``/``v_scale`` ``[NB, Nkv]``; every reader
dequantizes into the query dtype before the score dot. 1-byte arenas are
indexed through ``uint8`` views (some CUDA indexing ops lack fp8).

``backend`` picks the path (the port's counterpart of the JAX package's
``BACKENDS``, ``:80``, without the env override): ``"auto"`` launches
the kernel on a CUDA tensor and runs the plain version on a CPU tensor;
``"kernel"`` on a CPU tensor raises; ``"plain"`` is the plain version
anywhere, and on the card only ever an explicit caller choice.

``stats=True`` (context-parallel serving: each shard attends the blocks it
owns, and ``combine_attn_stats`` merges the shards) returns the
``attn_stats`` triple ``(acc, m, l)`` instead of the normalised output, on
every path: ``attn_stats`` on a CPU tensor, the same two kernels on the
card, which then mask columns of table entry 0 as well as by position and
write the f32 triple (``csrc/attn_tile.cuh``'s note). A row that sees no
live column is ``(0, -1e30, 0)`` on both.

Rows with no visible key are garbage on every path and are discarded by
the callers. They can differ between paths in one way: the prefill
kernel stops each row at ``nlive`` blocks, while the plain version reads
the row's whole window. Rows with a visible key agree.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from . import kernels
from .attention import NEG_INF, cached_attention
from .quant import is_kv_quantized, kv_dequantize, kv_qmax, kv_quantize

BACKENDS = ("auto", "kernel", "plain")
# paged decode: the most batch rows the kernel's on-card plan holds, and
# the most folded query rows one CTA holds with bf16 queries (three m16
# row tiles; more run as further row groups)
DECODE_MAX_BATCH = 512
DECODE_MAX_ROWS = 48
# chunked prefill on the tensor cores: query rows (chunk positions of one
# head) per CTA, keys per K/V tile, and the most runs a row is cut into
PREFILL_Q_ROWS = 128
PREFILL_TILE_COLS = 64
PREFILL_MAX_SPLITS = 16


def _bytes(arena: torch.Tensor) -> torch.Tensor:
    """A view the indexing ops take for every arena dtype."""
    return arena.view(torch.uint8) if is_kv_quantized(arena.dtype) else arena


def _take(arena: torch.Tensor, idx) -> torch.Tensor:
    """``arena[idx]`` as a copy in the arena's dtype."""
    return _bytes(arena)[idx].view(arena.dtype)


def gather_block_kv(
    k_arena: torch.Tensor,  # [NB, BS, Nkv, D]
    v_arena: torch.Tensor,
    block_table: torch.Tensor,  # [B, T]
    k_scale: Optional[torch.Tensor] = None,  # [NB, Nkv] f32, quantized arenas only
    v_scale: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,  # dequant target; default the scale dtype
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's logical window ``[B, T * BS, Nkv, D]``; trash-mapped
    entries (block 0) gather as zeros, selected after the dequant rather
    than multiplied (the trash block may hold Inf/NaN garbage, and its
    scale may be Inf)."""
    B, T = block_table.shape
    BS = k_arena.shape[1]
    idx = block_table.long()
    k, v = _take(k_arena, idx), _take(v_arena, idx)
    if k_scale is not None:
        dt = out_dtype or k_scale.dtype
        k = kv_dequantize(k, k_scale[idx][:, :, None, :, None], dt)
        v = kv_dequantize(v, v_scale[idx][:, :, None, :, None], dt)
    live = (block_table != 0)[:, :, None, None, None]
    k = torch.where(live, k, torch.zeros((), dtype=k.dtype, device=k.device))
    v = torch.where(live, v, torch.zeros((), dtype=v.dtype, device=v.device))
    return k.reshape(B, T * BS, *k.shape[3:]), v.reshape(B, T * BS, *v.shape[3:])


def _write_quantized(arena, scale, blk, slot, touched, inverse, new, keep):
    """The quantized branch of ``write_block_kv`` for one of K/V, in place.
    Reads every ``touched`` block before writing any and requantizes each
    once; ``inverse`` maps each entry to its row of ``touched``. A gated
    entry writes back its slot's requantized old code."""
    qmax = kv_qmax(arena.dtype)
    Nkv = new.shape[2]
    # candidate scale of each fresh entry; gated entries must not grow it
    cand = new.float().abs().amax(dim=-1) / qmax  # [B, S, Nkv]
    if keep is not None:
        cand = torch.where(keep[..., None], cand, torch.zeros((), device=cand.device))
    flat = blk.reshape(-1)
    s_old = scale[touched]  # [U, Nkv] pre-update scales
    old = _take(arena, touched)  # [U, BS, Nkv, D] codes
    scale.scatter_reduce_(
        0, flat[:, None].expand(-1, Nkv), cand.reshape(-1, Nkv), "amax", include_self=True
    )
    s_fin = scale[touched]
    # requantize the touched blocks to their final scales (round(q * 1.0)
    # where a scale did not grow), then land the fresh entries
    old_f = kv_dequantize(old, s_old[:, None, :, None], torch.float32)
    req = kv_quantize(old_f, s_fin[:, None, :, None], arena.dtype)
    codes = _bytes(arena)
    codes[touched] = req.view(torch.uint8)
    qn = kv_quantize(new, scale[blk][..., None], arena.dtype)
    if keep is not None:
        old_entry = req[inverse, slot]  # [B, S, Nkv, D]
        qn = torch.where(keep[..., None, None], qn, old_entry)
    codes[blk, slot] = qn.view(torch.uint8)


def write_block_kv(
    k_arena: torch.Tensor,  # [NB, BS, Nkv, D], updated IN PLACE
    v_arena: torch.Tensor,
    block_table: torch.Tensor,  # [B, T]
    cols: torch.Tensor,  # [B, S] logical columns of the new entries
    k_new: torch.Tensor,  # [B, S, Nkv, D]
    v_new: torch.Tensor,
    valid: Optional[torch.Tensor] = None,  # [B, S] bool; False keeps old contents
    k_scale: Optional[torch.Tensor] = None,  # [NB, Nkv] f32, quantized arenas only,
    v_scale: Optional[torch.Tensor] = None,  # updated IN PLACE
):
    """Scatter a step's fresh KV entries into their owning arena blocks.

    Unlike the JAX version, which returns new arrays, this writes the
    arenas (and scales) IN PLACE (an arena is gigabytes; a functional copy
    per layer per step would double it) and returns them: ``(k, v)``, or
    ``(k, v, k_scale, v_scale)`` for a quantized arena. Trash-mapped
    columns land in the shared trash block, which nobody reads; collisions
    there resolve in any order.

    A quantized arena quantizes at insert against a running per-block,
    per-head absmax: each entry's candidate scale is ``max|x| / qmax``,
    scales grow order-free (``amax``), every touched block's codes are
    requantized from its old scale to its final one, then the entries
    land quantized. The bytes equal the JAX function's.

    ``valid`` gates per entry as the JAX function does, without a host
    read (a boolean-mask index would be a ``nonzero``, one device→host
    sync per layer): a gated entry writes back the contents of its slot (a
    quantized arena's requantized code), and its candidate scale is zero,
    so the arena ends with the JAX function's bytes."""
    BS = k_arena.shape[1]
    W = block_table.shape[1] * BS
    cols = cols.long().clamp(0, W - 1)
    blk = torch.gather(block_table.long(), 1, cols // BS)
    slot = cols % BS
    keep = None
    if valid is not None:
        keep = torch.as_tensor(valid, device=cols.device).expand(cols.shape)
    if k_scale is not None:
        # the distinct blocks the entries touch: a one-entry-per-row decode
        # step's are distinct already (trash aside, whose identical
        # rewrites are harmless); a chunk of 256 entries hits ~4 blocks 64
        # times each (``torch.unique`` reads the device: never in decode)
        if blk.shape[1] == 1:
            touched = blk.reshape(-1)
            inverse = torch.arange(blk.shape[0], device=blk.device)[:, None]
        else:
            touched, inverse = torch.unique(blk, return_inverse=True)
        _write_quantized(k_arena, k_scale, blk, slot, touched, inverse, k_new, keep)
        _write_quantized(v_arena, v_scale, blk, slot, touched, inverse, v_new, keep)
        return k_arena, v_arena, k_scale, v_scale
    kn = k_new.to(k_arena.dtype)
    vn = v_new.to(v_arena.dtype)
    if keep is not None:
        kn = torch.where(keep[..., None, None], kn, k_arena[blk, slot])
        vn = torch.where(keep[..., None, None], vn, v_arena[blk, slot])
    k_arena[blk, slot] = kn
    v_arena[blk, slot] = vn
    return k_arena, v_arena


def paged_attention_xla(
    q: torch.Tensor,  # [B, S, Nh, D]
    k_arena: torch.Tensor,
    v_arena: torch.Tensor,
    block_table: torch.Tensor,  # [B, T]
    q_positions: torch.Tensor,  # [B, S]
    kv_positions: torch.Tensor,  # [B, T * BS]
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,  # [NB, Nkv], quantized arenas only
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain version of both paged kernels: gather (a quantized arena
    dequantizes into the query dtype, the kernels' target too), then the
    position-masked ``cached_attention``."""
    k, v = gather_block_kv(k_arena, v_arena, block_table, k_scale, v_scale, out_dtype=q.dtype)
    return cached_attention(q, k, v, q_positions, kv_positions, scale)


def attn_stats(
    q: torch.Tensor,  # [B, S, Nh, D]
    k_arena: torch.Tensor,  # [NB, BS, Nkv, D]
    v_arena: torch.Tensor,
    block_table: torch.Tensor,  # [B, T]
    q_positions: torch.Tensor,  # [B, S]
    kv_positions: torch.Tensor,  # [B, T * BS]
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,  # [NB, Nkv], quantized arenas only
    v_scale: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The online-softmax triple of each query row over its window, not
    normalised: ``acc [B, S, Nh, D]`` (f32, sum of ``exp(s - m) * v``),
    ``m [B, S, Nh]`` (row max) and ``l [B, S, Nh]`` (sum of ``exp(s - m)``);
    the counterpart of ``attn_stats_xla`` (``:284``). A column is masked by
    position AND by liveness (``block_table != 0``), and a masked column
    adds exactly zero, so a row with no visible column is ``(0, -1e30, 0)``."""
    B, S, Nh, D = q.shape
    BS = k_arena.shape[1]
    k, v = gather_block_kv(k_arena, v_arena, block_table, k_scale, v_scale, out_dtype=q.dtype)
    Nkv = k.shape[2]
    G = Nh // Nkv
    if scale is None:
        scale = D ** -0.5
    qg = q.reshape(B, S, Nkv, G, D).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    live = (block_table != 0).repeat_interleave(BS, dim=1)  # [B, T * BS]
    mask = ((kv_positions[:, None, :] <= q_positions[:, :, None]) & live[:, None, :])[:, None, None]
    scores = torch.where(mask, scores, torch.full((), NEG_INF, device=q.device))
    m = scores.amax(dim=-1)  # [B, Nkv, G, S]
    p = torch.where(mask, torch.exp(scores - m[..., None]), torch.zeros((), device=q.device))
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgst,btkd->bskgd", p.to(v.dtype).float(), v.float()).reshape(B, S, Nh, D)

    def to_bsn(x):
        return x.permute(0, 3, 1, 2).reshape(B, S, Nh)

    return acc, to_bsn(m), to_bsn(l)


def combine_attn_stats(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """Merge partial triples stacked on a leading split axis (``acc [P, B,
    S, Nh, D]``, ``m``/``l [P, B, S, Nh]``) into the normalised f32 output
    ``[B, S, Nh, D]``: ``combine_attn_stats`` (``:349``) over splits instead
    of mesh shards. A row no split attends comes out as zeros."""
    m_all = m.amax(dim=0)
    corr = torch.exp(m - m_all)  # a dead split's exp(-1e30 - m) is 0
    l_all = (l * corr).sum(dim=0)
    acc_all = (acc * corr[..., None]).sum(dim=0)
    return torch.where(
        l_all[..., None] > 0.0,
        acc_all / l_all.clamp_min(1e-30)[..., None],
        torch.zeros((), device=acc.device),
    )


def decode_block_size_ok(block_size: int) -> bool:
    """Block sizes the decode kernel takes: 8, 16, 32 or a multiple of 64
    (its TMA boxes are whole 8-row swizzle atoms that tile a 64-key, or a
    32-key f32, tile)."""
    return block_size in (8, 16, 32) or (block_size > 0 and block_size % 64 == 0)


def decode_tile_cols(dtype: torch.dtype) -> int:
    """Keys per K/V tile of the decode kernel: 64 for bf16 queries, 32 for
    f32 (a tile row is 128 bytes either way)."""
    return 64 if dtype == torch.bfloat16 else 32


def decode_row_group(GS: int, dtype: torch.dtype) -> int:
    """Folded query rows one decode CTA holds: bf16 pads ``G * S`` up to
    whole 16-row tiles, at most ``DECODE_MAX_ROWS``; f32 holds 16."""
    if dtype != torch.bfloat16:
        return 16
    return 16 * min(DECODE_MAX_ROWS // 16, -(-GS // 16))


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """The decode kernel's launch, from shapes alone: grid ``(pieces, Nkv,
    groups)``; ``rows`` folded rows of partial per slot and ``slots`` slots
    per (row, KV head, group) in the f32 scratch; ``tile_cols`` keys per
    tile; each busy piece holds at least ``min_tiles`` tiles (fewer pieces
    when the rows are short), so that no row's partials outweigh its KV."""

    pieces: int
    slots: int
    groups: int
    rows: int
    tile_cols: int
    min_tiles: int

    def scratch_floats(self, B: int, Nkv: int, D: int) -> int:
        # per (row, KV head, group): acc [slots][rows][D], then (m, l) pairs
        # padded to whole float4s
        n = self.slots * self.rows
        return B * Nkv * self.groups * (n * D + -(-2 * n // 4) * 4)


@functools.lru_cache(maxsize=None)
def plan_decode(
    B: int, S: int, Nh: int, Nkv: int, T: int, BS: int, dtype: torch.dtype, sm_count: int
) -> DecodePlan:
    """Launch plan of the decode kernel. One CTA per SM: each of the
    ``Nkv * groups`` (KV head, row group) pairs gets ``sm_count // (Nkv *
    groups)`` pieces (at least one), and a row is cut into at most as many
    pieces as its table has tiles. Depends on nothing but its arguments (so
    it is cached): the lengths stay on the card (``decode_pieces``)."""
    GS = (Nh // Nkv) * S
    rg = decode_row_group(GS, dtype)
    groups = -(-GS // rg)
    tk = decode_tile_cols(dtype)
    pieces = max(1, sm_count // (Nkv * groups))
    slots = max(1, min(pieces, -(-T * BS // tk)))
    rows = min(rg, GS)
    # a partial is 4 * rows * D bytes written and read, a tile 256 * D of
    # K and V: a piece of ceil(rows / 8) tiles keeps them under a quarter
    return DecodePlan(pieces, slots, groups, rows, tk, max(1, -(-rows // 8)))


def decode_live_cols(B: int, T: int, BS: int, nlive=None) -> list:
    """Each row's live columns as the decode kernel reads them on the card:
    ``min(T, nlive) * BS`` when ``nlive`` is given, else the table's width
    ``T * BS``."""
    if nlive is None:
        return [T * BS] * B
    return [min(T, max(int(n), 0)) * BS for n in nlive]


def decode_pieces(live_cols, tile_cols: int, pieces: int, min_tiles: int = 1) -> list:
    """The decode kernel's partition, as each CTA computes it on the card:
    the rows' live tiles (``ceil(live / tile_cols)`` each) in row order
    form one line cut into ``P = min(pieces, ceil(N / min_tiles))`` equal
    pieces (piece j holds tiles ``[j N / P, (j + 1) N / P)``; pieces past
    ``P`` are idle). Returns, per piece, its runs ``(row,
    col_begin, col_end, slot, nparts)``: the run covers the row's columns
    ``[col_begin, col_end)`` (``col_end`` clipped at the live end), is
    partial ``slot`` of the row's ``nparts``, and the row's runs cover its
    live columns exactly once."""
    nt = [-(-int(c) // tile_cols) for c in live_cols]
    pre = [0]
    for n in nt:
        pre.append(pre[-1] + n)
    N = pre[-1]
    # no piece is empty, so a row's pieces are consecutive runs
    P = min(pieces, -(-N // min_tiles))

    def piece_of(u):
        return ((u + 1) * P + N - 1) // N - 1

    out = []
    for j in range(pieces):
        lo, hi = (j * N // P, (j + 1) * N // P) if j < P else (0, 0)
        runs, b, u = [], 0, lo
        while u < hi:
            while pre[b + 1] <= u:
                b += 1
            t_lo, t_hi = u - pre[b], min(hi, pre[b + 1]) - pre[b]
            jf, jl = piece_of(pre[b]), piece_of(pre[b + 1] - 1)
            runs.append((b, t_lo * tile_cols, min(t_hi * tile_cols, int(live_cols[b])),
                         j - jf, jl - jf + 1))
            u = pre[b] + t_hi
        out.append(runs)
    return out


def prefill_design(dtype: torch.dtype, block_size: int) -> str:
    """The chunked-prefill kernel's route, from the query dtype and the
    arena's block size alone: ``"wgmma"`` (tensor cores, TMA boxes over
    the block table) for bf16 queries at block size 16, 32 or a multiple
    of 64, else ``"tile"`` (CUDA-core FMAs; f32 on the tensor cores would
    be TF32, and other block sizes do not tile a 64-key box)."""
    bs_ok = block_size in (16, 32) or (block_size > 0 and block_size % 64 == 0)
    return "wgmma" if dtype == torch.bfloat16 and bs_ok else "tile"


def prefill_run_cols(live_cols: int, nsplit: int, block_size: int) -> int:
    """Length of each run when a row's ``live_cols`` written columns are cut
    into ``nsplit`` runs: an even share rounded up to a whole number of
    ``max(PREFILL_TILE_COLS, block_size)`` columns (a multiple of the block
    size and of the tile). Run ``i`` is ``[i * run, min((i + 1) * run,
    live_cols))``; trailing runs may be empty. The kernel computes the same
    from each row's own ``nlive``."""
    unit = max(PREFILL_TILE_COLS, block_size)
    share = -(-live_cols // max(1, nsplit))
    return -(-share // unit) * unit


def plan_prefill_splits(
    B: int, Sc: int, Nh: int, live_cols: int, block_size: int, sm_count: int
) -> tuple[int, int]:
    """Split plan of the tensor-core chunked prefill: ``(run_cols,
    nsplit)``. A chunk gives ``B * Nh * ceil(Sc / PREFILL_Q_ROWS)`` CTAs,
    each holding one SM (its rings fill the shared memory). When they fall
    short of ``sm_count``, each row's live columns are cut into ``nsplit``
    runs, as many as fit in one wave of the SMs, at most one per tile of
    ``live_cols`` and at most ``PREFILL_MAX_SPLITS``; ``run_cols`` is
    ``prefill_run_cols`` of ``live_cols``. The wrapper passes the table's
    width (the frontier is on the device; each CTA sizes its run from its
    row's own). Depends on nothing but its arguments."""
    ctas = B * Nh * -(-Sc // PREFILL_Q_ROWS)
    unit = max(PREFILL_TILE_COLS, block_size)
    nsplit = 1
    if 0 < ctas < sm_count:
        nsplit = max(1, min(sm_count // ctas, -(-live_cols // unit), PREFILL_MAX_SPLITS))
    return prefill_run_cols(live_cols, nsplit, block_size), nsplit


def _use_kernel(name: str, q: torch.Tensor, backend: str) -> bool:
    if backend not in BACKENDS:
        raise ValueError(f"{name} backend {backend!r}: expected one of {BACKENDS}")
    if backend == "plain":
        return False
    if q.device.type == "cpu":
        if backend == "kernel":
            raise ValueError(f"{name}: backend='kernel' needs CUDA tensors, got cpu")
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {q.device}")
    return True


def _check_paged(q, k_arena, v_arena, block_table, q_positions, kv_positions, k_scale, v_scale):
    B, S = q.shape[:2]
    T = block_table.shape[1]
    BS = k_arena.shape[1]
    if tuple(kv_positions.shape) != (B, T * BS):
        raise ValueError(
            f"kv_positions must be [B, T*BS]={(B, T * BS)}, got {tuple(kv_positions.shape)}"
        )
    code = kernels.check_attention_inputs(q, k_arena, v_arena, k_scale, v_scale)
    tbl = kernels.int32_operand("block_table", block_table, (B, T), q.device)
    qpos = kernels.int32_operand("q_positions", q_positions, (B, S), q.device)
    kvpos = kernels.int32_operand("kv_positions", kv_positions, (B, T * BS), q.device)
    return code, tbl, qpos, kvpos


def _scale_ptrs(k_scale, v_scale) -> tuple[int, int]:
    if k_scale is None:
        return 0, 0
    return k_scale.data_ptr(), v_scale.data_ptr()


def _outputs(q: torch.Tensor, stats: bool):
    """The paged kernels' outputs: ``(out, None, (out, 0, 0, 0))``, or in
    stats mode ``(None, (acc, m, l), (0, acc, m, l))``, f32 ``acc [B, S,
    Nh, D]`` and ``m`` / ``l [B, S, Nh]``, with the pointers the entry
    points take (out, then the stats triple; null where unused)."""
    if not stats:
        out = torch.empty_like(q)
        return out, None, (out.data_ptr(), 0, 0, 0)
    acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    m, l = torch.empty((2,) + tuple(q.shape[:3]), dtype=torch.float32, device=q.device)
    return None, (acc, m, l), (0, acc.data_ptr(), m.data_ptr(), l.data_ptr())


def paged_attention(
    q: torch.Tensor,  # [B, S, Nh, D], decode S = 1
    k_arena: torch.Tensor,  # [NB, BS, Nkv, D]
    v_arena: torch.Tensor,
    block_table: torch.Tensor,  # [B, T] int32
    q_positions: torch.Tensor,  # [B, S] int32
    kv_positions: torch.Tensor,  # [B, T * BS] int32
    scale: Optional[float] = None,
    *,
    nlive: Optional[torch.Tensor] = None,  # [B] int32 blocks covering the written frontier
    k_scale: Optional[torch.Tensor] = None,  # [NB, Nkv] f32, quantized arenas only
    v_scale: Optional[torch.Tensor] = None,
    backend: str = "auto",
    stats: bool = False,
):
    """Decode attention of each row over exactly the blocks its table
    names (kernel 1, or ``paged_attention_xla``; see ``backend``). The
    kernel reads each row's first ``nlive`` blocks only (the server passes
    the blocks covering its written frontier, 0 for a finished row, whose
    output is then zeros), or the whole table without ``nlive``; the plain
    version reads the window. ``stats=True`` returns ``(acc, m, l)``
    (``attn_stats``'s triple) instead; a row with no live column is then
    ``(0, -1e30, 0)``."""
    if not _use_kernel("paged_attention", q, backend):
        if stats:
            return attn_stats(
                q, k_arena, v_arena, block_table, q_positions, kv_positions, scale, k_scale,
                v_scale,
            )
        return paged_attention_xla(
            q, k_arena, v_arena, block_table, q_positions, kv_positions, scale, k_scale, v_scale
        )
    B, S, Nh, D = q.shape
    NBk, BS, Nkv = k_arena.shape[:3]
    T = block_table.shape[1]
    if not decode_block_size_ok(BS):
        raise ValueError(f"paged_attention: block size {BS} (the kernel takes 8, 16, 32 or a "
                         "multiple of 64)")
    if B > DECODE_MAX_BATCH:
        raise ValueError(f"paged_attention: {B} rows (the kernel plans at most "
                         f"{DECODE_MAX_BATCH})")
    if scale is None:
        scale = D ** -0.5
    code, tbl, qpos, kvpos = _check_paged(
        q, k_arena, v_arena, block_table, q_positions, kv_positions, k_scale, v_scale
    )
    nl = 0
    if nlive is not None:
        nl = kernels.int32_operand("nlive", nlive, (B,), q.device).data_ptr()
    kv, mode = kernels.kv_storage(k_arena, stats)
    plan = plan_decode(B, S, Nh, Nkv, T, BS, q.dtype, kernels.sm_count(q.device))
    # per-piece partials (acc, then (m, l) pairs, per (group, row, KV head)),
    # merged in the launch; the kernel allocates nothing
    part = torch.empty(plan.scratch_floats(B, Nkv, D), dtype=torch.float32, device=q.device)
    tickets = kernels.PAGED_DECODE.tickets(q.device, B * Nkv * plan.groups)
    out, st, ptrs = _outputs(q, stats)
    kernels.PAGED_DECODE.launch(
        q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(), *_scale_ptrs(k_scale, v_scale),
        tbl.data_ptr(), qpos.data_ptr(), kvpos.data_ptr(), nl, *ptrs, part.data_ptr(),
        tickets.data_ptr(), B, S, Nh, Nkv, D, BS, T, NBk, plan.pieces, plan.slots,
        plan.min_tiles, float(scale), code, kv, kernels.current_stream_handle(q.device),
        mode=mode,
    )
    return st if stats else out


def paged_prefill(
    q: torch.Tensor,  # [B, Sc, Nh, D], one prompt chunk per row
    k_arena: torch.Tensor,
    v_arena: torch.Tensor,
    block_table: torch.Tensor,  # [B, T] int32
    q_positions: torch.Tensor,  # [B, Sc] int32
    kv_positions: torch.Tensor,  # [B, T * BS] int32
    scale: Optional[float] = None,
    nlive: Optional[torch.Tensor] = None,  # [B] blocks covering the written frontier
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    backend: str = "auto",
    stats: bool = False,
):
    """Chunked-prefill attention over the arena (kernel 2, or
    ``paged_attention_xla``, which reads the whole window: the ``nlive``
    clamp only bounds the kernel's KV traffic). On the card the route is
    ``prefill_design(q.dtype, BS)``; the tensor-core route cuts rows into
    ``plan_prefill_splits`` runs whose partials a second pass merges (one
    launch count per call). ``stats=True`` returns ``(acc, m, l)``
    (``attn_stats``'s triple) instead."""
    if not _use_kernel("paged_prefill", q, backend):
        if stats:
            return attn_stats(
                q, k_arena, v_arena, block_table, q_positions, kv_positions, scale, k_scale,
                v_scale,
            )
        return paged_attention_xla(
            q, k_arena, v_arena, block_table, q_positions, kv_positions, scale, k_scale, v_scale
        )
    B, S, Nh, D = q.shape
    BS, Nkv = k_arena.shape[1], k_arena.shape[2]
    T = block_table.shape[1]
    if scale is None:
        scale = D ** -0.5
    code, tbl, qpos, kvpos = _check_paged(
        q, k_arena, v_arena, block_table, q_positions, kv_positions, k_scale, v_scale
    )
    if nlive is None:
        nlive = torch.full((B,), T, dtype=torch.int32, device=q.device)
    nl = kernels.int32_operand("nlive", nlive.clamp(0, T).to(torch.int32), (B,), q.device)
    kv, mode = kernels.kv_storage(k_arena, stats)
    design = prefill_design(q.dtype, BS)
    nsplit = 1
    if design == "wgmma":
        _, nsplit = plan_prefill_splits(B, S, Nh, T * BS, BS, kernels.sm_count(q.device))
    part_acc = part_ml = 0
    if nsplit > 1:
        # per-run partials (acc [B, Nkv, nsplit, G*S, D], then (m, l) pairs)
        # that the kernel's second pass merges; the kernel allocates nothing
        rows = B * nsplit * Nh * S
        part = torch.empty(rows * (D + 2), dtype=torch.float32, device=q.device)
        part_acc, part_ml = part.data_ptr(), part.data_ptr() + rows * D * 4
    out, st, ptrs = _outputs(q, stats)
    kernels.PAGED_PREFILL.launch(
        q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(), *_scale_ptrs(k_scale, v_scale),
        tbl.data_ptr(), qpos.data_ptr(), kvpos.data_ptr(), nl.data_ptr(), *ptrs,
        part_acc, part_ml, B, S, Nh, Nkv, D, BS, T, k_arena.shape[0], nsplit, float(scale), code,
        kv, int(design == "wgmma"), kernels.current_stream_handle(q.device), mode=mode,
    )
    return st if stats else out
