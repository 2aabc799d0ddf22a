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
        #: decodes ids for a server's stop strings (``decode(ids,
        #: skip_special_tokens=True)``, as a Hugging Face tokenizer); None: no
        #: stop strings
        self.tokenizer = None

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
        chunk_cycles: int = 1,
        top_k: int = 0,
        top_p: float = 1.0,
        prefill_chunk: Optional[int] = None,
        pipeline_depth: int = 1,
        inflight_steps: int = 1,
        kv_block_size: Optional[int] = None,
        kv_blocks: Optional[int] = None,
        kv_dtype: str = "bf16",
        paged_attn: str = "auto",
        prefix_cache: str = "off",
        host_pool_blocks: int = 0,
        disk_pool_dir: Optional[str] = None,
        disk_pool_blocks: int = 0,
        max_queue: Optional[int] = None,
        default_deadline_s: Optional[float] = None,
        fault_plan=None,
        fault_retries: int = 3,
        fault_backoff_s: float = 0.01,
        retryable_exceptions: tuple = (),
        snapshot_every_s: Optional[float] = None,
        snapshot_path: Optional[str] = None,
        speculate: int = 0,
        spec_ngram: int = 3,
        trace_path: Optional[str] = None,
        gauge_sweep_every_s: float = 0.0,
    ):
        """A paged continuous-batching server over ``batch_per_slot`` rows
        (``runtime/server.PipelineServer``). Paged KV is required here:
        dense serving comes with a later slice. ``kv_dtype`` ("bf16" = the
        engine's dtype, "int8", "fp8") is the arena's storage;
        ``paged_attn`` ("auto", "kernel", "plain") the paged attention
        path; ``prefix_cache`` ("off", "hbm", "host", "disk") the automatic
        prefix cache, with the host tier's size in blocks
        (``host_pool_blocks``, default the arena's) and the disk tier's
        directory and size (``disk_pool_dir``, ``disk_pool_blocks``).
        Resilience: ``max_queue`` bounds the queue, ``default_deadline_s``
        each request's life; ``fault_plan`` (``runtime/faults.FaultPlan``)
        injects faults, retried ``fault_retries`` times from
        ``fault_backoff_s`` (``retryable_exceptions``: real errors that may
        be retried where the operation can be issued again);
        ``snapshot_every_s`` / ``snapshot_path`` arm auto-snapshots.
        ``speculate=K`` verifies up to K n-gram drafts per row per step
        (``spec_ngram``: the longest suffix matched; not with
        ``prefill_chunk``), as JAX ``runtime/engine.py:501-612``.
        Observability: ``trace_path`` streams the server's spans to a
        rotating JSONL file (they always reach the in-memory flight
        recorder), ``gauge_sweep_every_s`` paces the per-step load-gauge
        sweep (0: every step), as JAX ``server.py:905``, ``:924``. The step
        loop: ``chunk_cycles`` decode steps per dispatch, ``pipeline_depth``
        logs left in flight by the serial loop, ``inflight_steps`` > 1 the
        async executor (``runtime/async_exec.py``); ``top_k`` / ``top_p``
        are the defaults of requests that give none (JAX
        ``runtime/engine.py:488-612``)."""
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
            self, capacity=capacity, batch_per_slot=batch_per_slot, chunk_cycles=chunk_cycles,
            top_k=top_k, top_p=top_p, prefill_chunk=prefill_chunk,
            pipeline_depth=pipeline_depth, inflight_steps=inflight_steps,
            kv_block_size=kv_block_size, kv_blocks=kv_blocks,
            kv_dtype=kv_dtype, paged_attn=paged_attn, prefix_cache=prefix_cache,
            host_pool_blocks=host_pool_blocks, disk_pool_dir=disk_pool_dir,
            disk_pool_blocks=disk_pool_blocks, max_queue=max_queue,
            default_deadline_s=default_deadline_s, fault_plan=fault_plan,
            fault_retries=fault_retries, fault_backoff_s=fault_backoff_s,
            retryable_exceptions=retryable_exceptions, snapshot_every_s=snapshot_every_s,
            snapshot_path=snapshot_path, speculate=speculate, spec_ngram=spec_ngram,
            trace_path=trace_path, gauge_sweep_every_s=gauge_sweep_every_s,
        )
