"""Cached causal attention, GQA-aware (counterpart of
``llm_sharding_tpu/ops/attention.py:21-66``).

The contract every attention path of the port keeps:

- the mask is position-based, ``kv_pos <= q_pos`` (padding and empty
  slots carry the sentinel ``2**30`` and drop out);
- masked scores are ``-1e30``, not ``-inf``, so a query row with no
  visible key averages uniformly instead of producing NaN;
- scores and the softmax run in fp32 (operands are upcast, so a bf16
  product is exact and only the accumulation rounds);
- probabilities are cast to the V dtype before the PV product.

This is also the plain version of the dense flash kernel
(``ops/flash_attention.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def cached_attention(
    q: torch.Tensor,  # [B, S, Nh, D], RoPE'd
    k_cache: torch.Tensor,  # [B, C, Nkv, D], new keys already written
    v_cache: torch.Tensor,  # [B, C, Nkv, D]
    q_positions: torch.Tensor,  # [B, S]
    kv_positions: torch.Tensor,  # [B, C] (sentinel for empty slots)
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal attention of ``q`` over the cache → ``[B, S, Nh, D]``. Query
    head ``h = k * G + g`` reads KV head ``k``."""
    B, S, Nh, D = q.shape
    Nkv = k_cache.shape[2]
    G = Nh // Nkv
    if scale is None:
        scale = D ** -0.5
    qg = q.reshape(B, S, Nkv, G, D).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k_cache.float()) * scale
    mask = (kv_positions[:, None, :] <= q_positions[:, :, None])[:, None, None]
    scores = torch.where(mask, scores, torch.full((), NEG_INF, device=q.device))
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum(
        "bkgst,btkd->bskgd", probs.to(v_cache.dtype).float(), v_cache.float()
    )
    return out.reshape(B, S, Nh, D).to(q.dtype)
