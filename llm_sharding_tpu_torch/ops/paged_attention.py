"""Attention over the pooled paged KV arena: the decode kernel (kernel 1)
and the chunked-prefill kernel (kernel 2), unquantized mode.

Counterpart of ``llm_sharding_tpu/ops/paged_attention.py``:

- ``gather_block_kv`` (``:133``) and ``write_block_kv`` (``:172``, the
  unquantized branch with entry-granular ``valid``);
- ``paged_attention_xla`` (``:264``), the plain version of both kernels:
  gather each row's logical window, then ``cached_attention``;
- ``paged_attention`` → ``csrc/paged_attention.cu``, the port of
  ``paged_attention_tpu`` (``:484``, body ``_paged_kernel`` at ``:404``);
- ``paged_prefill`` → ``csrc/paged_prefill.cu``, the port of
  ``paged_prefill_tpu`` (``:689``, body ``_paged_prefill_kernel`` at
  ``:619``).

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises. The arena is ``[NB, BS, Nkv, D]``, the block table ``[B, T]``
(entry 0 is the reserved trash block, which reads as zeros everywhere),
and ``kv_positions`` is per LOGICAL column ``[B, T * BS]``: column ``c``
of row ``b`` lives in arena block ``table[b, c // BS]`` at slot
``c % BS``.

Rows with no visible key are garbage on every path and are discarded by
the callers. They can differ between paths in one way: the prefill
kernel stops each row at ``nlive`` blocks, while the plain version reads
the row's whole window. Rows with a visible key agree.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernels
from .attention import cached_attention


def gather_block_kv(
    k_arena: torch.Tensor,  # [NB, BS, Nkv, D]
    v_arena: torch.Tensor,
    block_table: torch.Tensor,  # [B, T]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's logical window ``[B, T * BS, Nkv, D]``; trash-mapped
    entries (block 0) gather as zeros, selected rather than multiplied
    (the trash block may hold Inf/NaN garbage)."""
    B, T = block_table.shape
    BS = k_arena.shape[1]
    idx = block_table.long()
    live = (block_table != 0)[:, :, None, None, None]
    zero = torch.zeros((), dtype=k_arena.dtype, device=k_arena.device)
    k = torch.where(live, k_arena[idx], zero)
    v = torch.where(live, v_arena[idx], zero)
    return k.reshape(B, T * BS, *k.shape[3:]), v.reshape(B, T * BS, *v.shape[3:])


def write_block_kv(
    k_arena: torch.Tensor,  # [NB, BS, Nkv, D], updated IN PLACE
    v_arena: torch.Tensor,
    block_table: torch.Tensor,  # [B, T]
    cols: torch.Tensor,  # [B, S] logical columns of the new entries
    k_new: torch.Tensor,  # [B, S, Nkv, D]
    v_new: torch.Tensor,
    valid: Optional[torch.Tensor] = None,  # [B, S] bool; False keeps old contents
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter a step's fresh KV entries into their owning arena blocks.

    Unlike the JAX version, which returns new arrays, this writes the
    arenas IN PLACE (an arena is gigabytes; a functional copy per layer per
    step would double it) and returns them. Trash-mapped columns land in
    the shared trash block, which nobody reads; collisions there resolve
    in any order."""
    BS = k_arena.shape[1]
    W = block_table.shape[1] * BS
    cols = cols.long().clamp(0, W - 1)
    blk = torch.gather(block_table.long(), 1, cols // BS)
    slot = cols % BS
    kn = k_new.to(k_arena.dtype)
    vn = v_new.to(v_arena.dtype)
    if valid is not None:
        keep = torch.as_tensor(valid, device=cols.device).expand(cols.shape)
        blk, slot, kn, vn = blk[keep], slot[keep], kn[keep], vn[keep]
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
) -> torch.Tensor:
    """The plain version of both paged kernels: gather, then the
    position-masked ``cached_attention``."""
    k, v = gather_block_kv(k_arena, v_arena, block_table)
    return cached_attention(q, k, v, q_positions, kv_positions, scale)


def _check_paged(q, k_arena, v_arena, block_table, q_positions, kv_positions):
    B, S = q.shape[:2]
    T = block_table.shape[1]
    BS = k_arena.shape[1]
    if tuple(kv_positions.shape) != (B, T * BS):
        raise ValueError(
            f"kv_positions must be [B, T*BS]={(B, T * BS)}, got {tuple(kv_positions.shape)}"
        )
    code = kernels.check_attention_inputs(q, k_arena, v_arena)
    tbl = kernels.int32_operand("block_table", block_table, (B, T), q.device)
    qpos = kernels.int32_operand("q_positions", q_positions, (B, S), q.device)
    kvpos = kernels.int32_operand("kv_positions", kv_positions, (B, T * BS), q.device)
    return code, tbl, qpos, kvpos


def paged_attention(
    q: torch.Tensor,  # [B, S, Nh, D], decode S = 1
    k_arena: torch.Tensor,  # [NB, BS, Nkv, D]
    v_arena: torch.Tensor,
    block_table: torch.Tensor,  # [B, T] int32
    q_positions: torch.Tensor,  # [B, S] int32
    kv_positions: torch.Tensor,  # [B, T * BS] int32
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention of each row over exactly the blocks its table
    names (kernel 1 on CUDA, ``paged_attention_xla`` on the CPU)."""
    if q.device.type == "cpu":
        return paged_attention_xla(
            q, k_arena, v_arena, block_table, q_positions, kv_positions, scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, not {q.device}")
    B, S, Nh, D = q.shape
    BS, Nkv = k_arena.shape[1], k_arena.shape[2]
    T = block_table.shape[1]
    if scale is None:
        scale = D ** -0.5
    code, tbl, qpos, kvpos = _check_paged(
        q, k_arena, v_arena, block_table, q_positions, kv_positions
    )
    out = torch.empty_like(q)
    kernels.PAGED_DECODE.launch(
        q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(), tbl.data_ptr(),
        qpos.data_ptr(), kvpos.data_ptr(), out.data_ptr(), B, S, Nh, Nkv, D, BS, T,
        float(scale), code, kernels.current_stream_handle(q.device),
    )
    return out


def paged_prefill(
    q: torch.Tensor,  # [B, Sc, Nh, D], one prompt chunk per row
    k_arena: torch.Tensor,
    v_arena: torch.Tensor,
    block_table: torch.Tensor,  # [B, T] int32
    q_positions: torch.Tensor,  # [B, Sc] int32
    kv_positions: torch.Tensor,  # [B, T * BS] int32
    scale: Optional[float] = None,
    nlive: Optional[torch.Tensor] = None,  # [B] blocks covering the written frontier
) -> torch.Tensor:
    """Chunked-prefill attention over the arena (kernel 2 on CUDA,
    ``paged_attention_xla`` on the CPU, which reads the whole window: the
    ``nlive`` clamp only bounds the kernel's KV traffic)."""
    if q.device.type == "cpu":
        return paged_attention_xla(
            q, k_arena, v_arena, block_table, q_positions, kv_positions, scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill runs on cpu or cuda, not {q.device}")
    B, S, Nh, D = q.shape
    BS, Nkv = k_arena.shape[1], k_arena.shape[2]
    T = block_table.shape[1]
    if scale is None:
        scale = D ** -0.5
    code, tbl, qpos, kvpos = _check_paged(
        q, k_arena, v_arena, block_table, q_positions, kv_positions
    )
    if nlive is None:
        nlive = torch.full((B,), T, dtype=torch.int32, device=q.device)
    nl = kernels.int32_operand("nlive", nlive.clamp(0, T).to(torch.int32), (B,), q.device)
    out = torch.empty_like(q)
    kernels.PAGED_PREFILL.launch(
        q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(), tbl.data_ptr(),
        qpos.data_ptr(), kvpos.data_ptr(), nl.data_ptr(), out.data_ptr(), B, S, Nh, Nkv,
        D, BS, T, float(scale), code, kernels.current_stream_handle(q.device),
    )
    return out
