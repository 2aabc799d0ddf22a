"""Rotary position embeddings (counterpart of
``llm_sharding_tpu/ops/rope.py:24-73``): HF ``rotate_half`` convention and
Llama-3 frequency scaling, recomputed from positions on every call.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.config import ModelConfig, RopeScaling


def _llama3_scale_inv_freq(inv_freq: np.ndarray, rs: RopeScaling) -> np.ndarray:
    """Piecewise Llama-3.x frequency scaling (``rope.py:24-38``)."""
    low_freq_wavelen = rs.original_max_position_embeddings / rs.low_freq_factor
    high_freq_wavelen = rs.original_max_position_embeddings / rs.high_freq_factor
    wavelen = 2 * np.pi / inv_freq
    scaled = np.where(wavelen > low_freq_wavelen, inv_freq / rs.factor, inv_freq)
    smooth = (rs.original_max_position_embeddings / wavelen - rs.low_freq_factor) / (
        rs.high_freq_factor - rs.low_freq_factor
    )
    smoothed = (1 - smooth) / rs.factor * inv_freq + smooth * inv_freq
    is_medium = ~(wavelen < high_freq_wavelen) & ~(wavelen > low_freq_wavelen)
    return np.where(is_medium, smoothed, scaled)


def inv_frequencies(cfg: ModelConfig) -> np.ndarray:
    """Inverse frequencies ``[head_dim / 2]``, fp32 (computed in fp64)."""
    d = cfg.head_dim_
    inv_freq = 1.0 / (cfg.rope_theta ** (np.arange(0, d, 2, dtype=np.float64) / d))
    if cfg.rope_scaling is not None and cfg.rope_scaling.rope_type == "llama3":
        inv_freq = _llama3_scale_inv_freq(inv_freq, cfg.rope_scaling)
    return inv_freq.astype(np.float32)


def rope_cos_sin(
    positions: torch.Tensor, cfg: ModelConfig, dtype=torch.float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin for absolute ``positions [...]`` → two ``[..., head_dim]``."""
    inv_freq = torch.from_numpy(inv_frequencies(cfg)).to(positions.device)
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x [B, S, N, D]`` by per-position ``cos/sin [B, S, D]``."""
    c = cos[:, :, None, :].float()
    s = sin[:, :, None, :].float()
    x32 = x.float()
    half = x.shape[-1] // 2
    rotated = torch.cat([-x32[..., half:], x32[..., :half]], dim=-1)
    return (x32 * c + rotated * s).to(x.dtype)
