"""RMS normalization (counterpart of ``llm_sharding_tpu/ops/norms.py:15-27``).

Accumulates in fp32 whatever the activation dtype, like the JAX version.
"""

from __future__ import annotations

import torch


def rms_norm(
    x: torch.Tensor, weight: torch.Tensor, eps: float, offset: float = 0.0
) -> torch.Tensor:
    """``offset`` reproduces families whose checkpoints store the scale as
    a delta from one (Gemma: ``out * (1 + w)``, computed in fp32)."""
    dtype = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    x32 = x32 * torch.rsqrt(var + eps)
    if offset:
        return (x32 * (offset + weight.float())).to(dtype)
    return x32.to(dtype) * weight
