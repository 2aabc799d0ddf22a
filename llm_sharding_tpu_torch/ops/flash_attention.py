"""Dense causal flash attention for prefill (kernel 3), and the
prefill/step attention dispatch.

Counterpart of ``llm_sharding_tpu/ops/flash_attention.py``: the TPU kernel
``flash_attention`` (``:124``, body ``_flash_kernel`` at ``:63``) becomes
``csrc/flash_attention.cu``, and ``attention_prefill`` / ``attention_step``
(``:201-245``) keep their roles. The plain version is
``ops/attention.cached_attention``: same position mask, same fp32
softmax, same ``-1e30`` masking, so a row with no visible key gives the
same uniform average on both (callers discard such rows).

What bounds the kernel on the H100, and what its design does about it:
``csrc/attn_tile.cuh``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernels
from .attention import cached_attention


def flash_attention(
    q: torch.Tensor,  # [B, S, Nh, D] (RoPE'd)
    k_cache: torch.Tensor,  # [B, C, Nkv, D], keys already written
    v_cache: torch.Tensor,  # [B, C, Nkv, D]
    q_positions: torch.Tensor,  # [B, S] int32
    kv_positions: torch.Tensor,  # [B, C] int32
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal attention over the cache. A CPU tensor runs the plain version;
    a CUDA tensor launches ``csrc/flash_attention.cu`` or raises."""
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
    qpos = kernels.int32_operand("q_positions", q_positions, (B, S), q.device)
    kvpos = kernels.int32_operand("kv_positions", kv_positions, (B, C), q.device)
    out = torch.empty_like(q)
    kernels.FLASH.launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), qpos.data_ptr(),
        kvpos.data_ptr(), out.data_ptr(), B, S, C, Nh, Nkv, D, float(scale), code,
        kernels.current_stream_handle(q.device),
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
