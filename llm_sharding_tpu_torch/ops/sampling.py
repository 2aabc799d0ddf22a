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

from ..device import device_const
from ..models.config import ModelConfig


def is_stop(cfg: ModelConfig, token: torch.Tensor) -> torch.Tensor:
    """``token [B]`` → bool ``[B]``: the token is any of the stop ids."""
    stops = device_const(tuple(cfg.eos_token_ids), token.dtype, token.device)
    return (token[:, None] == stops[None, :]).any(dim=-1)


def validate_top_p(top_p) -> float:
    top_p = float(top_p)
    if not (0.0 < top_p <= 1.0):
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    return top_p


def top_p_threshold(scaled: torch.Tensor, top_p, presorted: bool = False) -> torch.Tensor:
    """``[B, V]`` scaled logits → ``[B, 1]`` smallest logit kept by nucleus
    filtering, applied as a VALUE threshold (ties at the boundary are all
    kept, as in ``sampling.py:34-63``). ``top_p`` is a float, or one value
    per row (``[B]`` or ``[B, 1]`` tensor: the serving path's per-request
    values); ``presorted`` skips the sort when ``scaled`` is already
    descending along the vocabulary."""
    desc = scaled if presorted else torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    if isinstance(top_p, torch.Tensor) and top_p.dim() == 1:
        top_p = top_p[:, None]
    keep = (cum - probs) < top_p
    inf = torch.full((), float("inf"), device=scaled.device)
    return torch.where(keep, desc, inf).amin(dim=-1, keepdim=True)


def filter_rows(scaled: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Per-row top-k then top-p filtering of a ``[R, P, V]`` block of
    temperature-scaled logits (``P`` positions of each row, e.g. a
    verify's K + 1), as ``serve_verify`` does inline (JAX
    ``parallel/serve.py:1669-1684``): ``top_k [R]`` (0 = off) and ``top_p
    [R]`` (1.0 = off) are each row's own; masked entries become ``-inf``.
    Both thresholds come from one descending sort; the nucleus is taken
    over what top-k kept."""
    R, P, V = scaled.shape
    ninf = torch.full((), float("-inf"), device=scaled.device)
    desc = torch.sort(scaled, dim=-1, descending=True).values
    top_k = top_k.to(device=scaled.device, dtype=torch.long)
    top_p = top_p.to(device=scaled.device, dtype=torch.float32)
    k_idx = (top_k - 1).clamp(0, V - 1)[:, None, None].expand(R, P, 1)
    kth = torch.gather(desc, -1, k_idx)
    kth = torch.where((top_k > 0)[:, None, None], kth, ninf)
    desc_k = torch.where(desc < kth, ninf, desc)
    pth = top_p_threshold(
        desc_k.reshape(R * P, V), top_p.repeat_interleave(P), presorted=True
    ).reshape(R, P, 1)
    pth = torch.where((top_p < 1.0)[:, None, None], pth, ninf)
    return torch.where(scaled < torch.maximum(kth, pth), ninf, scaled)


def gumbel(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard Gumbel noise, ``-log(-log(u))``, ``u`` uniform from
    ``generator``."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


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
    if noise is None:
        noise = gumbel(scaled.shape, generator, scaled.device)
    return (scaled + noise.to(scaled.device)).argmax(dim=-1).to(torch.int32)
