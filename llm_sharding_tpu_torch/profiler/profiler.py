"""Capability profiler: the port of ``llm_sharding_tpu/profiler/profiler.py``.

It measures a device's prefill and decode capability on the port's own
model table and fits the latency models that placement reads
(``runtime/placement.py``, ``PlacementSpec.from_capabilities``):

- the prefill latency sweep over prompt lengths, with warm-up and repeats
  (``profile_prefill``, JAX ``:165-217``);
- the per-token capability ``c_k`` in seconds per (token · layer),
  normalised by the layers held;
- the decode cumulative-latency curve (``profile_decode``, ``:221-278``);
- linear and quadratic least-squares fits with RMSE and R² (``:57-84``);
- the prefill ≈ decode similarity verdict at a 30 % threshold (``:319-353``);
- cold-start shard-load latency, total and per layer (``:496-518``);
- the layers that fit device memory, by accounting (``:360-493``);
- a layer slice timed standalone on synthetic activations (``profile_stage``,
  ``:282-315``);
- the per-hop latency of a decode-shaped block around a ring of devices
  (``measure_hop_latency``, ``:586-668``).

Timing: every timed call is bracketed by ``torch.cuda.synchronize(device)``
on the card (the reference's own discipline, which the JAX docstring cites
at ``:26-29``: the host enqueues asynchronously, so a clock read without a
sync measures submission, not execution); on the CPU the call is plain
``time.perf_counter``. The warm-up runs also take the CUDA kernels'
first-use build and load (``ops/kernels.py``), so no ``nvcc`` time lands
in a timed sample.

Not here: the JAX table of memory sizes by TPU generation
(``HBM_GIB_BY_KIND``, ``hbm_bytes_for_device_kind``). ``detect_hbm_bytes``
reads a CUDA device's memory from the driver and returns ``None`` on the
CPU, which is what the JAX function returns on a host it cannot read.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models.cache import KVCache, init_cache
from ..models.config import ModelConfig
from ..ops.quant import base
from ..parallel.pipeline import model_fns, visible_devices

DEFAULT_PREFILL_LENGTHS = (8, 16, 32, 64, 128, 256, 512)
DEFAULT_REPEATS = 3
SIMILARITY_THRESHOLD = 0.30


# ---------------------------------------------------------------------------
# Latency-model fitting
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LatencyFit:
    kind: str  # "linear" | "quadratic"
    coeffs: tuple  # highest-order first: (a, b) for aS+b; (a, b, c) for aS²+bS+c
    rmse: float
    r2: float

    def predict(self, x) -> np.ndarray:
        return np.polyval(np.asarray(self.coeffs), np.asarray(x, np.float64))


def fit_latency_models(x: Sequence[float], y: Sequence[float]) -> dict[str, LatencyFit]:
    """Least-squares linear T(S)=aS+b and quadratic T(S)=aS²+bS+c fits with
    RMSE and R²; a fit with fewer points than coefficients is left out."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    out = {}
    for kind, deg in (("linear", 1), ("quadratic", 2)):
        if len(x) < deg + 1:
            continue
        coeffs = np.polyfit(x, y, deg)
        pred = np.polyval(coeffs, x)
        resid = y - pred
        rmse = float(np.sqrt(np.mean(resid**2)))
        ss_tot = float(np.sum((y - y.mean()) ** 2))
        r2 = 1.0 - float(np.sum(resid**2)) / ss_tot if ss_tot > 0 else 1.0
        out[kind] = LatencyFit(kind, tuple(float(c) for c in coeffs), rmse, r2)
    return out


# ---------------------------------------------------------------------------
# Reports
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PrefillReport:
    lengths: tuple  # prompt token lengths measured
    latencies_s: tuple  # median-of-repeats wall seconds per length
    capability_c_k: float  # sec per (token · full-model-layer)
    fits: dict  # {"linear": LatencyFit, "quadratic": LatencyFit}
    num_layers_measured: int
    num_layers_model: int


@dataclasses.dataclass(frozen=True)
class DecodeReport:
    token_counts: tuple  # cumulative output-token counts
    cumulative_s: tuple  # cumulative latency at each count
    capability_c_k: float  # sec per (token · layer), from mean marginal cost
    fits: dict


@dataclasses.dataclass(frozen=True)
class SimilarityVerdict:
    avg_ratio: float  # mean decode/prefill per-token cost ratio
    slope_ratio: float  # linear-slope ratio
    quadratic_marginal_ratio: float  # 2aS+b marginal-cost ratio at mid-sweep
    similar: bool  # all ratios within threshold of 1.0
    threshold: float


@dataclasses.dataclass(frozen=True)
class ColdStartReport:
    total_s: float
    per_layer_s: tuple
    num_layers: int


# ---------------------------------------------------------------------------
# Profiler
# ---------------------------------------------------------------------------

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timeit(fn: Callable[[], Any], device: torch.device) -> float:
    """Wall seconds of ``fn()``, the device's queue drained before and after."""
    _sync(device)
    t0 = time.perf_counter()
    fn()
    _sync(device)
    return time.perf_counter() - t0


def _positions(S: int, batch_size: int, start: int, device) -> torch.Tensor:
    return torch.arange(start, start + S, dtype=torch.int32, device=device).repeat(batch_size, 1)


class Profiler:
    """Capability measurement of the model steps on the device that holds
    ``params``.

    ``params`` is the port's params dict of a whole model or of a layer
    slice (its ``"layers"`` list holds the layers held); capabilities are
    normalised to full-model-layer units (``num_hidden_layers /
    num_layers_held``), as in JAX.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params: Any,
        *,
        dtype=torch.bfloat16,
        cooldown_s: float = 0.0,
    ):
        self.cfg = cfg
        self.params = params
        self.dtype = dtype
        self.cooldown_s = cooldown_s
        self.num_layers_held = len(params["layers"])
        self.device = base(next(iter(params["layers"][0].values()))).device

    # -- prefill ------------------------------------------------------------

    def profile_prefill(
        self,
        lengths: Sequence[int] = DEFAULT_PREFILL_LENGTHS,
        repeats: int = DEFAULT_REPEATS,
        batch_size: int = 1,
    ) -> PrefillReport:
        cfg, dev = self.cfg, self.device
        lengths = tuple(s for s in lengths if s <= cfg.max_position_embeddings)
        fwd = model_fns(cfg).forward

        def run(S: int) -> float:
            ids = torch.zeros((batch_size, S), dtype=torch.int32, device=dev)
            pos = _positions(S, batch_size, 0, dev)
            cache = init_cache(cfg, batch_size, S, dtype=self.dtype, device=dev,
                               num_layers=self.num_layers_held)
            return _timeit(lambda: fwd(cfg, self.params, ids, cache, pos)[0], dev)

        # warm-up: longest, shortest, then every length (first-sample outliers,
        # and on the card the kernels' first-use build and load)
        for S in (max(lengths), min(lengths)):
            run(S)
        for S in lengths:
            run(S)

        med = []
        for S in lengths:
            samples = []
            for _ in range(repeats):
                samples.append(run(S))
                if self.cooldown_s:
                    time.sleep(self.cooldown_s)
            med.append(float(np.median(samples)))

        scale = cfg.num_hidden_layers / self.num_layers_held
        per_token = [t * scale / s for t, s in zip(med, lengths)]
        c_k = float(np.mean(per_token)) / cfg.num_hidden_layers

        return PrefillReport(
            lengths=lengths,
            latencies_s=tuple(med),
            capability_c_k=c_k,
            fits=fit_latency_models(lengths, med),
            num_layers_measured=self.num_layers_held,
            num_layers_model=cfg.num_hidden_layers,
        )

    # -- decode -------------------------------------------------------------

    def profile_decode(
        self,
        max_tokens: int = 64,
        prompt_len: int = 8,
        batch_size: int = 1,
        measure_every: int = 8,
    ) -> DecodeReport:
        """Cumulative decode latency against the output-token count. Needs
        the whole model held, since decode needs logits."""
        if self.num_layers_held != self.cfg.num_hidden_layers:
            raise ValueError(
                "decode profiling needs the full model on this device "
                f"(holding {self.num_layers_held}/{self.cfg.num_hidden_layers} "
                "layers); profile the stage with profile_stage instead"
            )
        cfg, dev = self.cfg, self.device
        fwd = model_fns(cfg).forward
        capacity = prompt_len + max_tokens

        def step(ids, cache, at: int):
            pos = torch.full((batch_size, 1), at, dtype=torch.int32, device=dev)
            return fwd(cfg, self.params, ids, cache, pos)

        ids = torch.zeros((batch_size, prompt_len), dtype=torch.int32, device=dev)
        cache = init_cache(cfg, batch_size, capacity, dtype=self.dtype, device=dev)
        logits, cache = fwd(cfg, self.params, ids, cache, _positions(prompt_len, batch_size, 0, dev))
        _sync(dev)
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        # warm the one-token step on a copy: the cache is written in place
        warm = KVCache(cache.k.clone(), cache.v.clone(), cache.pos.clone(), cache.length)
        step(tok, warm, prompt_len)
        _sync(dev)
        del warm

        counts, cums = [], []
        t_start = time.perf_counter()
        cur = tok
        for t in range(max_tokens):
            logits, cache = step(cur, cache, prompt_len + t)
            cur = logits[:, -1:].argmax(-1).to(torch.int32)
            if (t + 1) % measure_every == 0 or t == max_tokens - 1:
                _sync(dev)
                counts.append(t + 1)
                cums.append(time.perf_counter() - t_start)

        marginal = np.diff([0.0] + cums) / np.diff([0] + counts)
        c_k = float(np.mean(marginal)) / cfg.num_hidden_layers

        return DecodeReport(
            token_counts=tuple(counts),
            cumulative_s=tuple(cums),
            capability_c_k=c_k,
            fits=fit_latency_models(counts, cums),
        )

    # -- stage profiling ----------------------------------------------------

    def profile_stage(
        self,
        seq_len: int,
        batch_size: int = 1,
        repeats: int = DEFAULT_REPEATS,
        layer_mask: Optional[torch.Tensor] = None,
    ) -> float:
        """Median seconds of one pass of the held layers over synthetic
        hidden states: a slice too small to hold the whole model is timed
        standalone, with no second device to host the rest."""
        cfg, dev = self.cfg, self.device
        stage = model_fns(cfg).stage
        h = torch.zeros((batch_size, seq_len, cfg.hidden_size), dtype=self.dtype, device=dev)
        pos = _positions(seq_len, batch_size, 0, dev)
        cache = init_cache(cfg, batch_size, seq_len, dtype=self.dtype, device=dev,
                           num_layers=self.num_layers_held)

        def run() -> float:
            cache.length = 0  # each pass writes the same columns anew
            return _timeit(
                lambda: stage(cfg, self.params["layers"], h, cache, pos, layer_mask)[0], dev
            )

        run()
        samples = [run() for _ in range(repeats)]
        return float(np.median(samples))

    # -- similarity verdict -------------------------------------------------

    @staticmethod
    def similarity_verdict(
        prefill: PrefillReport,
        decode: DecodeReport,
        threshold: float = SIMILARITY_THRESHOLD,
    ) -> SimilarityVerdict:
        avg_ratio = decode.capability_c_k / prefill.capability_c_k
        ratios = [avg_ratio]
        slope_ratio = float("nan")
        if "linear" in prefill.fits and "linear" in decode.fits:
            slope_ratio = (
                decode.fits["linear"].coeffs[0] / prefill.fits["linear"].coeffs[0]
            )
            ratios.append(slope_ratio)
        # marginal cost 2aS+b of the quadratic fits at mid-sweep; quadratic
        # fits exist only with >= 3 sample points
        quad_ratio = float("nan")
        if "quadratic" in prefill.fits and "quadratic" in decode.fits:
            s_mid = float(np.mean(prefill.lengths))
            aq_p, bq_p, _ = prefill.fits["quadratic"].coeffs
            aq_d, bq_d, _ = decode.fits["quadratic"].coeffs
            t_mid = float(np.mean(decode.token_counts))
            marg_p = 2 * aq_p * s_mid + bq_p
            marg_d = 2 * aq_d * t_mid + bq_d
            quad_ratio = marg_d / marg_p if marg_p else float("inf")
            ratios.append(quad_ratio)
        similar = all(abs(r - 1.0) <= threshold for r in ratios)
        return SimilarityVerdict(
            avg_ratio=float(avg_ratio),
            slope_ratio=float(slope_ratio),
            quadratic_marginal_ratio=float(quad_ratio),
            similar=similar,
            threshold=threshold,
        )


# ---------------------------------------------------------------------------
# Memory fit + cold start
# ---------------------------------------------------------------------------

def layer_param_bytes(cfg: ModelConfig, dtype=torch.bfloat16) -> int:
    """Exact per-decoder-layer parameter bytes from the config."""
    H, I, D = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim_
    Nh, Nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    if cfg.model_type == "llama":
        n = (
            2 * H  # norms
            + H * Nh * D + 2 * H * Nkv * D + Nh * D * H  # attention
            + 3 * H * I  # mlp
        )
    else:  # gpt2
        n = 4 * H + H * 3 * H + 3 * H + H * H + H + 2 * H * I + I + H
    return n * dtype.itemsize


def kv_cache_bytes_per_layer(
    cfg: ModelConfig, batch_size: int, capacity: int, dtype=torch.bfloat16
) -> int:
    return 2 * batch_size * capacity * cfg.num_key_value_heads * cfg.head_dim_ * dtype.itemsize


def max_layers_fit(
    cfg: ModelConfig,
    *,
    batch_size: int = 1,
    kv_capacity: int = 4096,
    param_dtype=torch.bfloat16,
    cache_dtype=torch.bfloat16,
    device=None,
    hbm_bytes: Optional[int] = None,
    reserve_fraction: float = 0.10,
    with_head: bool = True,
) -> int:
    """Decoder layers that fit device memory, by accounting: the budget less
    a reserve (and the embedding, head and final norm), over one layer's
    weights and KV cache rows."""
    if hbm_bytes is None:
        hbm_bytes = detect_hbm_bytes(device)
        if hbm_bytes is None:
            raise ValueError(
                "device memory is not determinable on this host: pass "
                "hbm_bytes explicitly"
            )
    budget = int(hbm_bytes * (1.0 - reserve_fraction))
    if with_head:
        itemsize = param_dtype.itemsize
        budget -= cfg.vocab_size * cfg.hidden_size * itemsize * 2  # embed+head
        budget -= cfg.hidden_size * itemsize
    per_layer = layer_param_bytes(cfg, param_dtype) + kv_cache_bytes_per_layer(
        cfg, batch_size, kv_capacity, cache_dtype
    )
    return max(0, min(cfg.num_hidden_layers, budget // per_layer))


def detect_hbm_bytes(device=None) -> Optional[int]:
    """A CUDA device's total memory, from the driver; ``None`` on the CPU
    (and with ``device=None`` on a host without a GPU), so callers leave
    memory-dependent results out instead of guessing."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = "cuda"
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(resolve_device(dev)).total_memory)


def stage_memory_bytes(
    cfg: ModelConfig,
    placement,  # PlacementSpec
    *,
    batch_size: int = 1,
    kv_capacity: int = 4096,
    param_dtype=torch.bfloat16,
    cache_dtype=torch.bfloat16,
    head_dtype=None,
) -> list[int]:
    """Per-stage device memory of a placement: the stage's layer weights at
    ``max_layers_per_stage`` (the JAX stages are padded to it), their KV
    cache rows and the stage's vocab shard of the head
    (``parallel/head.head_bytes_per_stage``). Quantized models: pass
    ``param_dtype=torch.int8`` for int8/int4-resident layer weights and
    ``head_dtype`` for the vocab tables (default ``param_dtype``)."""
    from ..parallel.head import head_bytes_per_stage

    S = placement.num_stages
    Lp = placement.max_layers_per_stage
    per_layer = layer_param_bytes(cfg, param_dtype)
    kv = kv_cache_bytes_per_layer(cfg, batch_size, kv_capacity, cache_dtype)
    head = head_bytes_per_stage(cfg, S, (head_dtype or param_dtype).itemsize)
    return [Lp * (per_layer + kv) + head for _ in range(S)]


def profile_cold_start(
    shards_dir: str,
    start: int = 0,
    end: Optional[int] = None,
    dtype=torch.bfloat16,
    device=None,
) -> ColdStartReport:
    """Shard-load latency onto ``device`` (default the GPU), total and per
    layer: each ``block_{i}.npz`` read and its tensors made resident, the
    device synced after each layer. Reads a store of either package."""
    from ..utils import shard_store

    dev = resolve_device(device)
    cfg = shard_store.load_config(shards_dir)
    end = end if end is not None else cfg.num_hidden_layers
    per_layer = []
    t_total0 = time.perf_counter()
    for i in range(start, end):
        t0 = time.perf_counter()
        shard_store._load_npz(os.path.join(shards_dir, f"block_{i}.npz"), dtype, dev)
        _sync(dev)
        per_layer.append(time.perf_counter() - t0)
    total = time.perf_counter() - t_total0
    return ColdStartReport(
        total_s=total, per_layer_s=tuple(per_layer), num_layers=end - start
    )


# ---------------------------------------------------------------------------
# Inter-stage hop latency
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HopLatencyReport:
    """Per-hop latency of a pipeline-shaped hidden block passed around a
    ring of devices (``measure_hop_latency``)."""

    p50_us: float
    p99_us: float
    mean_us: float
    bytes_per_hop: int
    hops_per_sample: int
    samples: int


def _calibrate_chain(
    make_run,
    n_hops: int,
    *,
    target_s: float = 0.4,
    cap: int = 1_000_000,
    jitter_mult: float = 10.0,
    min_per_hop_s: float = 20e-9,
    run_short=None,
) -> tuple:
    """Size the long chain for the difference method: grow the calibration
    chain geometrically until its delta over the short chain clears a
    jitter floor (``jitter_mult`` × the min-of-3 spread of the short run),
    then size ``n_long`` for ~``target_s`` of pure hop work; ``cap`` is the
    last resort for immeasurable hops.

    ``make_run(n)`` returns a zero-arg callable timing one warmed n-hop
    chain; pass ``run_short`` when the caller already built the short
    runner. Returns ``(n_long, per_hop_est_s, run_long)``, ``run_long``
    the calibration's runner when ``n_long`` equals its length, else
    ``None``."""
    if run_short is None:
        run_short = make_run(n_hops)
    shorts = sorted(run_short() for _ in range(3))
    floor = jitter_mult * (shorts[-1] - shorts[0])
    n_mid = n_hops * 8
    while True:
        run_mid = make_run(n_mid)
        d = min(run_mid() - run_short() for _ in range(3))
        if (d > floor and d > 0.0) or n_mid >= cap:
            break
        n_mid = min(n_mid * 8, cap)
    per_hop = max(d / (n_mid - n_hops), min_per_hop_s)
    n_long = int(min(max(n_mid, target_s / per_hop), cap))
    return n_long, per_hop, (run_mid if n_long == n_mid else None)


def measure_hop_latency(
    devices: Sequence,
    *,
    hidden_size: int = 4096,
    batch: int = 1,
    n_hops: int = 128,
    repeats: int = 30,
    dtype=torch.bfloat16,
) -> HopLatencyReport:
    """Time chains of dependent hops of a decode-shaped ``[batch, 1,
    hidden]`` block around the ring ``devices`` (a list may repeat a
    device, as the port's stages do on one card) and report per-hop
    percentiles.

    A hop is a ``copy_`` of the block into a buffer allocated beforehand on
    the next ring device; each copy reads the previous copy's output, so
    the hops cannot overlap. A ring of one device ping-pongs two buffers on
    it. Each sample is the difference method: a long chain minus a short
    chain, over the hop delta, so the issue and sync costs common to both
    cancel. The chain is issued from the host, as the port's stage chain
    issues its hops, so a hop costs the larger of its issue time and its
    copy. Between cards that is the link's cost; on one card it is the
    cost of an on-device copy of the block, not of a link between cards.
    """
    ring = visible_devices(devices)
    if len(ring) == 1:
        ring = ring * 2
    R = len(ring)
    bufs = [torch.ones((batch, 1, hidden_size), dtype=dtype, device=d) for d in ring]
    cards = sorted({d for d in ring if d.type == "cuda"}, key=str)

    def run(n: int) -> float:
        t0 = time.perf_counter()
        for i in range(n):
            bufs[(i + 1) % R].copy_(bufs[i % R], non_blocking=True)
        for d in cards:
            torch.cuda.synchronize(d)
        return time.perf_counter() - t0

    def make_run(n):
        run(n)  # warm
        return lambda: run(n)

    run_short = make_run(n_hops)
    n_long, _, run_long = _calibrate_chain(make_run, n_hops, run_short=run_short)
    if run_long is None:
        run_long = make_run(n_long)
    samples_us = np.array(
        [
            (run_long() - run_short()) / (n_long - n_hops) * 1e6
            for _ in range(repeats)
        ]
    )
    samples_us = np.maximum(samples_us, 0.0)  # jitter can cross zero
    return HopLatencyReport(
        p50_us=float(np.percentile(samples_us, 50)),
        p99_us=float(np.percentile(samples_us, 99)),
        mean_us=float(samples_us.mean()),
        bytes_per_hop=int(batch * hidden_size * dtype.itemsize),
        hops_per_sample=n_long - n_hops,
        samples=repeats,
    )
