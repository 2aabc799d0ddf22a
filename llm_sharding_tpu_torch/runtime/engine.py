"""Engine: the user-facing entry point (counterpart of
``llm_sharding_tpu/runtime/engine.py`` ``PipelineEngine``, ``:76``).

``Engine.from_shards(dir)`` loads a shard store onto the GPU (or the CPU
when asked), ``generate_ids`` runs the monolithic oracle and ``serve``
builds the paged continuous-batching server. One GPU, no pipeline stages:
placement, repartition and the mesh come with the pipeline slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..device import NotPorted, resolve_device
from ..utils import shard_store
from .generate import GenerateResult, generate


class Engine:
    """A model's weights on one device. The KV cache takes the weights'
    dtype: the attention kernels require the cache dtype to equal the
    query's. A separate cache dtype comes with KV quantization."""

    def __init__(self, cfg, params: dict):
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.cache_dtype = params["embed"].dtype

    @classmethod
    def from_shards(
        cls, shards_dir: str, *, dtype: torch.dtype = torch.bfloat16, device=None
    ) -> "Engine":
        """Load a store written by either package (default device: the GPU;
        raises without one unless ``device="cpu"``)."""
        cfg, params = shard_store.load_full(shards_dir, dtype=dtype, device=resolve_device(device))
        return cls(cfg, params)

    def generate_ids(self, prompt_ids, max_new_tokens: int = 128, **kw) -> GenerateResult:
        """The monolithic oracle (``runtime/generate.generate``)."""
        return generate(self.cfg, self.params, prompt_ids, max_new_tokens, **kw)

    def serve(
        self,
        *,
        capacity: int = 1024,
        batch_per_slot: int = 1,
        prefill_chunk: Optional[int] = None,
        kv_block_size: Optional[int] = None,
        kv_blocks: Optional[int] = None,
    ):
        """A paged continuous-batching server over ``batch_per_slot`` rows
        (``runtime/server.PipelineServer``). Paged KV is required here:
        dense serving comes with a later slice."""
        if kv_block_size is None and kv_blocks is None:
            raise NotPorted(
                "dense serving (serve() without kv_block_size/kv_blocks) comes with "
                "a later slice of the port (ROADMAP.md §A); pass kv_block_size and "
                "kv_blocks for paged serving"
            )
        if (kv_block_size is None) != (kv_blocks is None):
            raise ValueError(
                f"kv_block_size and kv_blocks go together (got kv_block_size="
                f"{kv_block_size!r}, kv_blocks={kv_blocks!r})"
            )
        from .server import PipelineServer

        return PipelineServer(
            self, capacity=capacity, batch_per_slot=batch_per_slot,
            prefill_chunk=prefill_chunk, kv_block_size=kv_block_size, kv_blocks=kv_blocks,
        )
