"""The layer loops shared by the model families (counterpart of
``llm_sharding_tpu/models/stack.py:24-134``).

The JAX package scans layer-stacked parameters with ``lax.scan`` and
threads the cache through the carry. The port keeps parameters as a list
of per-layer dicts and loops in Python; each layer updates its slice of
the cache (or its arena) in place.

``layer_mask`` (bool ``[L]``, from ``shard_store.load_stage(pad_to=)``)
marks the real layers of a stage padded to a common depth: a masked layer
leaves the hidden state and the KV as they were. The gate is a select on
the device, as in the JAX package: never a multiply (which would carry a
masked layer's non-finite output through) and never a host read.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .cache import KVCache


def scan_layers(
    layers: list,
    h: torch.Tensor,  # [B, S, H]
    cache: KVCache,
    positions: torch.Tensor,  # [B, S] int32
    apply_layer: Callable,  # (p, h, k_row, v_row, kv_pos, length) -> h
    layer_mask: Optional[torch.Tensor] = None,  # [L] bool
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
        k_row, v_row = cache.k[i], cache.v[i]
        if layer_mask is None:
            h = apply_layer(p, h, k_row, v_row, cache.pos, start)
            continue
        valid = layer_mask[i]
        fresh = slice(start, start + S)
        old_k, old_v = k_row[:, fresh].clone(), v_row[:, fresh].clone()
        h = torch.where(valid, apply_layer(p, h, k_row, v_row, cache.pos, start), h)
        k_row[:, fresh] = torch.where(valid, k_row[:, fresh], old_k)
        v_row[:, fresh] = torch.where(valid, v_row[:, fresh], old_v)
    cache.length = start + S
    return h, cache


def scan_layers_paged(
    layers: list,
    h: torch.Tensor,  # [B, S, H]
    k_arena: torch.Tensor,  # [L, NB, BS, Nkv, D] pooled per-layer blocks
    v_arena: torch.Tensor,
    apply_layer: Callable,  # (p, valid, h, k_l, v_l, ks_l, vs_l) -> h
    layer_mask: Optional[torch.Tensor] = None,  # [L] bool
    k_scale: Optional[torch.Tensor] = None,  # [L, NB, Nkv] f32, quantized arena
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Paged counterpart of ``scan_layers``: each layer scatters into and
    attends from its arena slice (and scale slice). A masked layer's
    ``valid`` goes INTO ``apply_layer``, which gates its scattered
    entries; the hidden-state gate is here. Key-position bookkeeping
    stays with the caller."""
    for i, p in enumerate(layers):
        valid = None if layer_mask is None else layer_mask[i]
        h_new = apply_layer(
            p, valid, h, k_arena[i], v_arena[i],
            None if k_scale is None else k_scale[i], None if v_scale is None else v_scale[i],
        )
        h = h_new if valid is None else torch.where(valid, h_new, h)
    return h
