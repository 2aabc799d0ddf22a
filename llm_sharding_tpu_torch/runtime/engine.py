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
from ..ops.quant import act_dtype, base
from ..utils import shard_store
from .generate import GenerateResult, generate


class Engine:
    """A model's weights on one device, llama family or GPT-2, raw or
    with int8 / int4 ``QTensor`` weights. The compute KV cache takes the
    weights' compute dtype (a quantized weight's scale dtype; the attention
    kernels take queries and an unquantized cache of one dtype); a
    server's paged arena may instead store int8 or fp8 codes
    (``serve(kv_dtype=)``), dequantized inside the kernels."""

    def __init__(self, cfg, params: dict):
        self.cfg = cfg
        self.params = params
        # a quantized table's codes are int8: its scale carries the dtype
        self.device = base(params["embed"]).device
        self.cache_dtype = act_dtype(params["embed"])

    @classmethod
    def from_shards(
        cls, shards_dir: str, *, dtype: torch.dtype = torch.bfloat16, device=None
    ) -> "Engine":
        """Load a store written by either package: llama family or GPT-2,
        raw or int8 / int4 quantized (``dtype`` casts the raw tensors and
        the scales, never the codes). Default device: the GPU; raises
        without one unless ``device="cpu"``."""
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
        kv_dtype: str = "bf16",
        paged_attn: str = "auto",
    ):
        """A paged continuous-batching server over ``batch_per_slot`` rows
        (``runtime/server.PipelineServer``). Paged KV is required here:
        dense serving comes with a later slice. ``kv_dtype`` ("bf16" = the
        engine's dtype, "int8", "fp8") is the arena's storage;
        ``paged_attn`` ("auto", "kernel", "plain") the paged attention
        path."""
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
            kv_dtype=kv_dtype, paged_attn=paged_attn,
        )
