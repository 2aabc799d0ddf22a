"""Token selection and stop predicates (counterpart of
``llm_sharding_tpu/ops/sampling.py:18-101``).

``sample`` is Gumbel-max, like the JAX version, but its noise comes from
an explicit ``torch.Generator`` (or is injected by the caller): torch
cannot reproduce JAX's threefry draws, so the parity tests hand both
packages the same noise and compare the chosen tokens.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.config import ModelConfig


def is_stop(cfg: ModelConfig, token: torch.Tensor) -> torch.Tensor:
    """``token [B]`` → bool ``[B]``: the token is any of the stop ids."""
    stops = torch.tensor(cfg.eos_token_ids, dtype=token.dtype, device=token.device)
    return (token[:, None] == stops[None, :]).any(dim=-1)


def validate_top_p(top_p) -> float:
    top_p = float(top_p)
    if not (0.0 < top_p <= 1.0):
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    return top_p


def top_p_threshold(scaled: torch.Tensor, top_p: float) -> torch.Tensor:
    """``[B, V]`` scaled logits → ``[B, 1]`` smallest logit kept by nucleus
    filtering, applied as a VALUE threshold (ties at the boundary are all
    kept, as in ``sampling.py:34-63``)."""
    desc = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p
    inf = torch.full((), float("inf"), device=scaled.device)
    return torch.where(keep, desc, inf).amin(dim=-1, keepdim=True)


def sample(
    logits: torch.Tensor,  # [B, V]
    temperature: float,
    top_k: int = 0,
    top_p: float = 1.0,
    *,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,  # [B, V] Gumbel noise to use
) -> torch.Tensor:
    """``[B, V]`` → ``[B]`` int32. ``temperature <= 0`` is greedy argmax.
    Filters compose HF-style: top-k first, then top-p over what survives."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    scaled = (logits / temperature).float()
    ninf = torch.full((), float("-inf"), device=scaled.device)
    if top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled < kth, ninf, scaled)
    if top_p < 1.0:
        scaled = torch.where(scaled < top_p_threshold(scaled, top_p), ninf, scaled)
    if noise is None:  # standard Gumbel, -log(-log(u))
        u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
        noise = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return (scaled + noise.to(scaled.device)).argmax(dim=-1).to(torch.int32)
