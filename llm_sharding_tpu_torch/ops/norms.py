"""RMS and layer normalization (counterpart of
``llm_sharding_tpu/ops/norms.py:15-38``).

Both accumulate in fp32 whatever the activation dtype, like the JAX
versions.
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


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float
) -> torch.Tensor:
    """GPT-2's LayerNorm: mean and (biased) variance in fp32, the
    normalized value cast to the activation dtype BEFORE ``* weight +
    bias``. ``F.layer_norm`` applies the affine step in fp32, which rounds
    differently in bf16."""
    dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    y = (x32 - mean) * (var + eps) ** -0.5
    return y.to(dtype) * weight + bias
