"""Weight-matmul helpers, raw-weight path (counterpart of
``llm_sharding_tpu/ops/quant.py:123-167``).

Weights keep the JAX package's ``[in, out]`` layout, so ``x @ w`` is the
projection and the tied head contracts against the ``[V, H]`` embedding
table. Logits are cast to fp32 AFTER the dot, as in the JAX package. The
int8/int4 ``QTensor`` path comes with the quantized-store slice; the shard
store refuses such stores (``utils/shard_store.py``).
"""

from __future__ import annotations

import torch


def qmatmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a raw ``[in, out]`` weight."""
    return x @ w


def embed_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Embedding lookup ``table[ids]`` on a raw ``[V, H]`` table."""
    return table[ids.long()]


def head_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Untied head ``x @ w`` (``w [H, V]``), fp32 after the dot."""
    return (x @ w).float()


def tied_logits(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Tied head ``x @ table.T`` (``table [V, H]``), fp32 after the dot."""
    return (x @ table.t()).float()
