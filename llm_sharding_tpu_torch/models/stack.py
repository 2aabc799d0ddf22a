"""The layer loops (counterpart of ``llm_sharding_tpu/models/stack.py``).

The JAX package scans layer-stacked parameters with ``lax.scan`` and
threads the cache through the carry. The port keeps parameters as a list
of per-layer dicts and loops in Python; each layer updates its slice of
the cache in place. The paged counterpart of ``scan_layers_paged`` is the
plain loop in ``llama.forward_layers_paged``; the ``layer_mask`` of ragged
pipeline stages comes with the pipeline slice.
"""

from __future__ import annotations

from typing import Callable

import torch

from .cache import KVCache


def scan_layers(
    layers: list,
    h: torch.Tensor,  # [B, S, H]
    cache: KVCache,
    positions: torch.Tensor,  # [B, S] int32
    apply_layer: Callable,  # (p, h, k_row, v_row, kv_pos, length) -> h
) -> tuple[torch.Tensor, KVCache]:
    """Record this step's key positions once, run every layer over its own
    cache row, advance the shared write offset."""
    S = h.shape[1]
    start = cache.length
    if start + S > cache.capacity:
        raise ValueError(
            f"cache write [{start}, {start + S}) exceeds capacity {cache.capacity}"
        )
    cache.pos[:, start : start + S] = positions
    for i, p in enumerate(layers):
        h = apply_layer(p, h, cache.k[i], cache.v[i], cache.pos, start)
    cache.length = start + S
    return h, cache

