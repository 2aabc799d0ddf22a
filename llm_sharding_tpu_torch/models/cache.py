"""Preallocated dense KV cache (counterpart of
``llm_sharding_tpu/models/cache.py``).

``k, v: [num_layers, batch, capacity, Nkv, D]`` plus ``pos: [batch,
capacity]``, the absolute position of each slot's key or the sentinel
``POS_SENTINEL`` (``cache.py:41``); attention masks on ``pos <= q_pos``,
so empty slots and padded prompt tokens drop out. ``length`` is the shared
write offset. Unlike the JAX cache (an immutable NamedTuple threaded
through ``jit``), the port's cache is updated in place by ``forward``.
"""

from __future__ import annotations

import dataclasses
import torch

from .config import ModelConfig

POS_SENTINEL = 2**30  # "no key here": larger than any real position


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # [L, B, C, Nkv, D]
    v: torch.Tensor  # [L, B, C, Nkv, D]
    pos: torch.Tensor  # [B, C] int32, position of each key or the sentinel
    length: int = 0  # shared write offset

    @property
    def capacity(self) -> int:
        return self.k.shape[2]

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]


def init_cache(
    cfg: ModelConfig,
    batch_size: int,
    capacity: int,
    dtype=torch.bfloat16,
    device=None,
) -> KVCache:
    """An empty cache on ``device`` (the caller resolves it)."""
    shape = (cfg.num_hidden_layers, batch_size, capacity, cfg.num_key_value_heads, cfg.head_dim_)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((batch_size, capacity), POS_SENTINEL, dtype=torch.int32, device=device),
    )


def block_pool_shape(cfg: ModelConfig, num_blocks: int, block_size: int) -> tuple:
    """Shape of the pooled paged arena, ``[L, num_blocks, block_size, Nkv,
    D]``. Block 0 is the reserved trash sink (``runtime/blocks.py``)."""
    if num_blocks < 2:
        raise ValueError(
            f"num_blocks must be >= 2 (block 0 is the reserved trash sink), got {num_blocks}"
        )
    if block_size < 1 or (block_size & (block_size - 1)):
        raise ValueError(f"block_size must be a power of two, got {block_size}")
    return (cfg.num_hidden_layers, num_blocks, block_size, cfg.num_key_value_heads, cfg.head_dim_)
