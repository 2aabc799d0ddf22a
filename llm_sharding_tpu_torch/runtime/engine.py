"""Engine: the user-facing entry point (counterpart of
``llm_sharding_tpu/runtime/engine.py`` ``PipelineEngine``, ``:76``).

``Engine.from_shards(dir)`` loads a shard store onto the GPU (or the CPU
when asked) with the store's tokenizer where it has one, ``generate_ids``
runs the oracle, ``serve`` builds the continuous-batching server (dense,
or paged with ``kv_block_size`` / ``kv_blocks``), and the text surface
(``generate_text``, ``generate_text_stream``) and the privacy entry's
``embed_prompt`` sit on top.

Pipeline stages: ``num_stages`` / ``placement`` (``parallel/placement``)
cut the model into contiguous layer ranges, each with its vocab shard of
the head (``parallel/head.py``), one per ``devices`` entry (a list may
repeat a device; ``None`` is every visible GPU). A chain longer than the
list runs grouped, as in JAX. Such an engine keeps the weights on the
host, and ``apply_placement`` re-slices them onto the devices at any time
(hot repartition). An engine built with none of the three loads straight
onto its device as one stage; ``keep_host_copy`` gives it the host copy
that repartition slices from.

Tensor and data parallelism (JAX ``engine.py:90-185``):
``tensor_parallel=T`` runs every stage over a tensor group of ``T``
devices (its megatron shards, ``parallel/tensor.py``), and
``data_parallel=D`` keeps ``D`` replicas of the chain that ``generate_ids``
splits a batch over. The devices follow the JAX grid ``(data, pipe,
tensor)``, tensor innermost, so ``devices = D × stages × T``; the stage
count defaults to ``devices / (D·T)``. ``serve`` composes with tensor
parallelism, not with in-program data parallelism
(``runtime/replicated.ReplicatedServer`` replicates servers instead).
"""

from __future__ import annotations

import logging
import time
from typing import Iterator, Optional

import numpy as np
import torch

from ..analysis.lockorder import named_lock
from ..device import resolve_device, to_device
from ..obs.metrics import PIPELINE_STAGES, PLACEMENT_SWAP_SECONDS, PLACEMENT_SWAPS
from ..ops.quant import act_dtype
from ..parallel.mesh import hybrid_mesh
from ..parallel.pipeline import (
    as_stages, build_stages, chain_embed, map_params, pipe_size, pipeline_generate,
    visible_devices,
)
from ..parallel.placement import PlacementSpec
from ..parallel.tensor import validate_tp
from ..utils import shard_store
from .generate import generate

logger = logging.getLogger("llm_sharding_tpu_torch.engine")


def text_deltas(tok, tokens) -> Iterator[str]:
    """The text a token stream adds, one delta per token that completes
    text: a delta is held back while the decoded text ends in a partial
    codepoint (JAX ``engine.py:695-701``, ``cli.py:1012-1016``)."""
    acc: list = []
    prev = ""
    for t in tokens:
        acc.append(t)
        text = tok.decode(acc, skip_special_tokens=True)
        if len(text) > len(prev) and not text.endswith("\ufffd"):
            yield text[len(prev):]
            prev = text


class Engine:
    """A model's weights on one device or cut into pipeline stages, llama
    family or GPT-2, raw or with int8 / int4 ``QTensor`` weights. The
    compute KV cache takes the weights' compute dtype (a quantized
    weight's scale dtype; the attention kernels take queries and an
    unquantized cache of one dtype); a server's paged arena may instead
    store int8 or fp8 codes (``serve(kv_dtype=)``), dequantized inside the
    kernels.

    ``num_stages`` (default: one per device), ``placement`` (a
    ``PlacementSpec``) and ``devices`` (default every visible GPU) make a
    pipeline engine over host-resident weights; without them ``params``
    stay where they are, one stage on their device."""

    def __init__(self, cfg, params: dict, *, num_stages: Optional[int] = None,
                 placement: Optional[PlacementSpec] = None, devices: Optional[list] = None,
                 tensor_parallel: int = 1, data_parallel: int = 1):
        self.cfg = cfg
        #: the store's tokenizer (``from_shards``), as a Hugging Face one:
        #: ``tok(text)["input_ids"]`` and ``decode(ids,
        #: skip_special_tokens=True)``; None: ids only (no text surface, no
        #: stop strings)
        self.tokenizer = None
        # the text stream's shared servers, by capacity (``_shared_server``)
        self._servers: dict = {}
        self._lock = named_lock("engine.reconfig")
        self.data_parallel = int(data_parallel)
        self.tensor_parallel = int(tensor_parallel)
        if self.data_parallel < 1 or self.tensor_parallel < 1:
            raise ValueError("data_parallel/tensor_parallel must be >= 1")
        if self.tensor_parallel > 1:
            validate_tp(cfg, self.tensor_parallel)
        L = cfg.num_hidden_layers
        parallel = self.data_parallel > 1 or self.tensor_parallel > 1
        if num_stages is None and placement is None and devices is None and not parallel:
            # loaded straight onto the device: one stage, no host copy
            self._host = None
            stages = as_stages(params)
            self._devices = [stages[0].device]
            self._commit(PlacementSpec.balanced(L, 1), PlacementSpec.balanced(L, 1), [stages],
                         time.perf_counter())
            return
        # the repartition source stays on the host: only each stage's slice
        # reaches its device (JAX ``host_staging``, ``engine.py:107-121``)
        self._host = map_params(lambda t: t.detach().to("cpu"), params)
        self._devices = visible_devices(devices)
        if placement is None:
            n = num_stages
            if n is None:
                rep = self.data_parallel * self.tensor_parallel
                if len(self._devices) % rep:
                    raise ValueError(
                        f"{len(self._devices)} devices not divisible by dp×tp = {rep}"
                    )
                n = len(self._devices) // rep
            placement = PlacementSpec.balanced(L, n)
        self.apply_placement(placement)

    def _pipe_size(self, num_virtual: int) -> int:
        """The executed stage count of a ``num_virtual``-stage chain (JAX
        ``engine.py:155-172``): ``pipe_size`` over the ``devices / (dp·tp)``
        pipe devices."""
        rep = self.data_parallel * self.tensor_parallel
        if rep > 1 and len(self._devices) < rep:
            raise ValueError(
                f"a {num_virtual}-stage chain needs at least one pipe device; 0 available "
                f"(dp×tp uses {rep} of {len(self._devices)})"
            )
        return pipe_size(num_virtual, len(self._devices) // rep)

    @classmethod
    def from_shards(
        cls, shards_dir: str, *, dtype: torch.dtype = torch.bfloat16, device=None,
        num_stages: Optional[int] = None, placement: Optional[PlacementSpec] = None,
        devices: Optional[list] = None, tensor_parallel: int = 1, data_parallel: int = 1,
    ) -> "Engine":
        """Load a store written by either package: llama family or GPT-2,
        raw or int8 / int4 quantized (``dtype`` casts the raw tensors and
        the scales, never the codes), and its tokenizer where the store
        holds one and ``transformers`` loads it (JAX ``engine.py:203``).
        Default device: the GPU; raises without one unless
        ``device="cpu"``. With ``num_stages``, ``placement`` or
        ``devices`` (``device`` alone: a one-entry list) the store loads
        into host memory and the engine stages it; so it does with
        ``tensor_parallel`` / ``data_parallel`` > 1 (``device`` alone: each
        shard and replica on it)."""
        parallel = tensor_parallel > 1 or data_parallel > 1
        if num_stages is None and placement is None and devices is None and not parallel:
            cfg, params = shard_store.load_full(shards_dir, dtype=dtype,
                                                device=resolve_device(device))
            eng = cls(cfg, params)
        else:
            if devices is None and device is not None:
                n = placement.num_stages if placement is not None else (num_stages or 1)
                devices = [device] * (n * tensor_parallel * data_parallel)
            devices = visible_devices(devices)
            cfg, params = shard_store.load_full(shards_dir, dtype=dtype, device="cpu")
            eng = cls(cfg, params, num_stages=num_stages, placement=placement, devices=devices,
                      tensor_parallel=tensor_parallel, data_parallel=data_parallel)
        eng.tokenizer = shard_store.load_tokenizer(shards_dir)
        return eng

    # -- control plane (JAX ``engine.py:218-356``) --------------------------

    def apply_placement(self, spec: PlacementSpec) -> None:
        """Hot-apply a new layer → stage mapping: re-slice the host weights
        onto the devices (a chain longer than the device list runs
        grouped). Live servers keep the arrays they were built on; new
        servers see the new placement. An engine loaded straight onto its
        device (no host copy) has that one device, so it runs any chain
        as one grouped stage."""
        if spec.num_layers != self.cfg.num_hidden_layers:
            raise ValueError(
                f"placement covers {spec.num_layers} layers but model has "
                f"{self.cfg.num_hidden_layers}"
            )
        t0 = time.perf_counter()
        dp, tp = self.data_parallel, self.tensor_parallel
        pipe = self._pipe_size(spec.num_stages)
        ex = spec if pipe == spec.num_stages else spec.grouped(spec.num_stages // pipe)
        if self._host is None:  # one device: any chain runs grouped as one stage
            replicas = [self.stages]
        else:
            grid = hybrid_mesh(data=dp, pipe=pipe, tensor=tp, devices=self._devices)
            replicas = [build_stages(self.cfg, self._host, ex, list(grid.devices[d].reshape(-1)),
                                     tp=tp) for d in range(dp)]
        self._commit(spec, ex, replicas, t0)
        logger.info("placement applied: %d stages over %d devices, ranges %s",
                    spec.num_stages, ex.num_stages, list(spec.stages))

    @property
    def host_staged(self) -> bool:
        """Whether the weights' host copy, the repartition source, is kept."""
        return self._host is not None

    def keep_host_copy(self, devices: list) -> None:
        """Copy the weights of an engine loaded straight onto its device to
        the host, as the source of later ``apply_placement`` calls, and take
        ``devices`` (a list may repeat a device) as its stage devices from
        the next placement on. The serving daemon calls it at its first
        ``:placement``, so a daemon that never repartitions keeps the direct
        load's memory and start-up time."""
        if self._host is None:
            self._host = map_params(lambda t: t.detach().to("cpu"), self.params)
        self._devices = visible_devices(devices)

    def _commit(self, spec: PlacementSpec, ex: PlacementSpec, replicas: list, t0: float) -> None:
        """Swap placement and stages in at once: a concurrent generate sees
        the old set or the new one, never a mix."""
        with self._lock:
            self.placement = spec  # the operator's chain (may be longer)
            self.exec_placement = ex  # what the devices run
            self._replicas = replicas  # one chain per data-parallel replica
            self._stages = replicas[0]
            # live servers are bound to the old arrays
            self._servers = {}
        PLACEMENT_SWAPS.inc()
        PLACEMENT_SWAP_SECONDS.observe(time.perf_counter() - t0)
        PIPELINE_STAGES.set(ex.num_stages)

    @property
    def stages(self) -> list:
        """The executed stages (``parallel/pipeline.Stage``), in chain order."""
        return self._stages

    @property
    def num_stages(self) -> int:
        """The executed stage count."""
        return len(self._stages)

    @property
    def device(self) -> torch.device:
        """The first stage's device: where requests enter and tokens land."""
        return self._stages[0].device

    @property
    def cache_dtype(self) -> torch.dtype:
        # a quantized table's codes are int8: its scale carries the dtype
        return act_dtype(self._stages[0].head["embed"])

    @property
    def params(self) -> dict:
        """A one-stage engine's params on its device (``layers`` and the
        head leaves); a pipeline or tensor-parallel engine has no such dict."""
        st = self._stages
        if len(st) != 1 or self.tensor_parallel > 1:
            raise ValueError(
                f"a {len(st)}-stage engine at tensor degree {self.tensor_parallel} holds no "
                "one-device params; its stages are engine.stages"
            )
        return {"layers": st[0].layers, **st[0].head}

    def generate_ids(self, prompt_ids, max_new_tokens: int = 128, **kw):
        """The monolithic oracle (``runtime/generate.generate``) on one
        stage; through the stage chain (``pipeline_generate``, which has no
        speculation) on more (JAX ``engine.py:364-409``)."""
        with self._lock:
            stages, replicas = self._stages, self._replicas
        if len(stages) == 1 and len(replicas) == 1 and self.tensor_parallel == 1:
            return generate(self.cfg, self.params, prompt_ids, max_new_tokens, **kw)
        if kw.get("speculate"):
            raise ValueError(
                f"speculate={kw['speculate']}: the pipeline's generate has no speculative "
                "decoding (serve(speculate=) verifies through the stages)"
            )
        kw = {k: v for k, v in kw.items() if k not in ("speculate", "spec_ngram", "spec_burst")}
        return pipeline_generate(self.cfg, replicas if len(replicas) > 1 else stages,
                                 prompt_ids, max_new_tokens, **kw)

    def generate_many(
        self,
        prompts,  # [R, S] right-padded, R <= num_stages * batch_per_slot
        max_new_tokens: int = 128,
        *,
        prompt_len=None,
        capacity: Optional[int] = None,
        temperature=0.0,
        top_k=0,
        top_p=1.0,
        seeds=None,
        batch_per_slot: Optional[int] = None,
    ):
        """Up to ``num_stages * batch_per_slot`` requests at once, each row
        with its own sampling settings and seed (JAX ``engine.py:411``;
        ``parallel/schedule.interleaved_generate``)."""
        from ..parallel.schedule import interleaved_generate

        self._require_pipe_only("generate_many")
        with self._lock:
            stages = self._stages
        return interleaved_generate(
            self.cfg, stages, prompts, max_new_tokens, prompt_len=prompt_len, capacity=capacity,
            batch_per_slot=batch_per_slot, temperature=temperature, top_k=top_k, top_p=top_p,
            seeds=seeds, num_stages=self.placement.num_stages,
        )

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
        cp: int = 1,
    ):
        """A continuous-batching server over ``num_stages ×
        batch_per_slot`` rows (``runtime/server.PipelineServer``, JAX
        ``server.py:1307``), every program through the stage chain:
        dense per-row caches of ``capacity`` columns by default, the JAX
        ``serve`` default, or the paged arena of ``kv_blocks`` blocks of ``kv_block_size`` (the two
        go together). ``kv_dtype`` ("bf16" = the
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
        ``runtime/engine.py:488-612``). On a tensor-parallel engine every
        program runs the stages' shards over head-split arenas (quantized
        KV refused, as in JAX); an in-program data-parallel engine does not
        serve (``_validate_serve``). ``cp`` > 1 is context-parallel serving
        (JAX ``engine.py:581-631``): each stage's paged arena is split by
        block over ``cp`` shards of the engine's devices (``cp × stages`` of
        them, a list may repeat a device), ``kv_blocks`` per shard, each
        shard attending its own blocks and the partials merged; the llama
        family only, paged, without speculation or tensor parallelism, and
        a prefix cache needs ``prefill_chunk``."""
        from .server import PipelineServer

        self._validate_serve()
        if cp > 1 and self.tensor_parallel > 1:
            raise NotImplementedError(
                "serve×cp×tp: the cp arena sharding and megatron heads "
                "sharding both claim the KV leaves' trailing dims — pick "
                "one (cp for long context, tp for big models)"
            )
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
            trace_path=trace_path, gauge_sweep_every_s=gauge_sweep_every_s, cp=cp,
        )

    def _validate_serve(self) -> None:
        """The engine's capability checks for serving, shared by ``serve``
        and ``PipelineServer.restore`` (JAX ``engine.py:468-490``, the same
        exception classes and words)."""
        if self.data_parallel > 1:
            raise NotImplementedError(
                "serve on an in-program dp engine: use "
                "runtime.replicated.ReplicatedServer — D replica servers "
                "over disjoint device groups behind a router (it forwards "
                "tensor_parallel, so dp×pp×tp serving is replicas of a "
                "pp×tp server)"
            )
        if self.tensor_parallel > 1 and self.cfg.model_type != "llama":
            raise NotImplementedError(
                "serve×tp supports the llama family (llama/qwen2): the "
                "engine stores llama weights megatron-pre-split, while "
                "gpt2's fused qkv is column-permuted inside "
                "pipeline_generate — its serve-side permutation is not "
                "implemented"
            )

    def _require_pipe_only(self, what: str) -> None:
        if self.data_parallel > 1 or self.tensor_parallel > 1:
            raise NotImplementedError(
                f"{what} runs on a pipe-only engine; in-program dp/tp hybrid "
                "engines support generate_ids (the shard_map pipeline "
                "program) and serve() composes with tp. For data-parallel "
                "continuous batching use runtime.replicated.ReplicatedServer "
                "— D replica servers over disjoint device groups behind a "
                "router."
            )

    # -- the text surface (JAX ``engine.py:449-768``) ----------------------

    def _require_tokenizer(self):
        if self.tokenizer is None:
            raise ValueError(
                "engine has no tokenizer: construct via from_shards on a store "
                "with tokenizer files, or pass tokenizer= explicitly"
            )
        return self.tokenizer

    def generate_text(
        self,
        prompt: str,
        max_new_tokens: int = 128,
        *,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = 0,
    ) -> str:
        """One prompt's completion as text, through ``generate``."""
        tok = self._require_tokenizer()
        ids = np.asarray(tok(prompt)["input_ids"], np.int32)[None]
        res = self.generate_ids(
            ids, max_new_tokens, temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
        )
        out_ids = res.tokens[0, ids.shape[1] : int(res.lengths[0])]
        return tok.decode(out_ids, skip_special_tokens=True)

    def generate_text_stream(
        self,
        prompt: str,
        max_new_tokens: int = 128,
        *,
        temperature: float = 0.0,
        seed: int = 0,
        top_k: int = 0,
        top_p: float = 1.0,
        stop=None,
    ) -> Iterator[str]:
        """Text deltas as the tokens commit, served by a shared dense
        server (``_shared_server``); a delta is held back while the decoded
        text ends in a partial codepoint."""
        tok = self._require_tokenizer()
        ids = np.asarray(tok(prompt)["input_ids"], np.int32)
        srv = self._shared_server(ids.shape[0], max_new_tokens)
        req = srv.submit(
            ids, max_new_tokens, temperature=temperature, seed=seed, top_k=top_k, top_p=top_p,
            stop=stop,
        )
        yield from text_deltas(tok, srv.stream(req))

    def _shared_server(self, prompt_len: int, max_new: int):
        """A ladder of dense servers by capacity (JAX ``engine.py:634``): a
        request that needs a larger one gets a new server beside the others,
        whose streams keep going; capacities are powers of two from 64."""
        from .server import ADMIT_BUCKETS

        if prompt_len > ADMIT_BUCKETS[-1]:
            raise ValueError(
                f"prompt length {prompt_len} exceeds the largest admission bucket "
                f"({ADMIT_BUCKETS[-1]})"
            )
        needed = next(b for b in ADMIT_BUCKETS if b >= prompt_len) + max_new
        with self._lock:
            for cap in sorted(self._servers):
                if cap >= needed:
                    return self._servers[cap]
            cap = 64
            while cap < needed:
                cap *= 2
            srv = self._servers[cap] = self.serve(capacity=cap)
            return srv

    def embed_prompt(self, prompt_ids, start: int = 0) -> torch.Tensor:
        """Token ids → the hidden states the first layer takes ``[B, S, H]``
        on the engine's device (JAX ``engine.py:706-732``): the table's rows
        (an int8 row-quantized table dequantized), GPT-2's position
        embedding (positions from ``start``: a migrated embedding request's
        tail continues its prompt) and gemma's multiplier. What a server's
        ``submit_embedding`` takes in place of the ids."""
        ids = np.asarray(prompt_ids, np.int32)
        if ids.ndim == 1:
            ids = ids[None]
        pos = np.broadcast_to(start + np.arange(ids.shape[1], dtype=np.int32), ids.shape)
        return chain_embed(self.cfg, self.stages, to_device(ids, self.device),
                           to_device(pos, self.device))
