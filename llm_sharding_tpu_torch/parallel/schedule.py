"""Many requests through the stage chain at once (the port of
``llm_sharding_tpu/parallel/schedule.py``: ``InterleavedResult`` ``:65``,
``interleaved_generate`` ``:322``).

The JAX schedule keeps ``num_stages`` slots of ``batch_per_slot`` rows in
flight, round-robin: at each microstep every device serves a different
slot, so every stage works every microstep. Its results are each row's
own: greedy rows decode what the monolithic oracle decodes, a seeded row
what ``generate(seed=)`` draws at batch 1. The port keeps those results
and the surface, not the microstep order: all rows run as one batch, one
pass down the chain per token. Rows are independent, so the tokens are
the same; and on one host thread that issues every launch, the
microstep order would launch every layer ``num_stages`` times per token
instead of once.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.config import ModelConfig
from ..ops.sampling import sample, validate_top_p
from .head import sp_head
from .pipeline import chain_generate, check_stage_shapes, validate_request


class InterleavedResult(NamedTuple):
    tokens: np.ndarray  # [R, S + max_new_tokens]
    lengths: np.ndarray  # [R]


def interleaved_generate(
    cfg: ModelConfig,
    stages: list,
    prompts,  # [R, S] with R <= num_stages * batch_per_slot
    max_new_tokens: int = 128,
    *,
    prompt_len=None,
    capacity: Optional[int] = None,
    batch_per_slot: Optional[int] = None,
    temperature=0.0,  # scalar or per-request [R]; <= 0 greedy
    top_k=0,  # scalar or per-request [R]; 0 off
    top_p=1.0,  # scalar or per-request [R]; 1.0 off
    seeds=None,  # per-request sampling seeds [R] (default zeros)
    num_stages: Optional[int] = None,  # the chain's stage count (default the stages')
) -> InterleavedResult:
    """Generate for up to ``num_stages * batch_per_slot`` requests at once
    (``batch_per_slot`` defaults to the least that fits them). Request
    ``r`` with ``temperature[r] > 0`` draws from its own generator seeded
    with ``seeds[r]``, exactly the tokens of the port's ``generate(...,
    seed=seeds[r])`` at batch 1; greedy rows never gather the vocab."""
    prompts = np.asarray(prompts, np.int32)
    if prompts.ndim == 1:
        prompts = prompts[None]
    R, S = prompts.shape
    num_stages = num_stages or len(stages)
    if batch_per_slot is None:
        batch_per_slot = max(1, -(-R // num_stages))
    M = num_stages * batch_per_slot
    if R > M:
        raise ValueError(
            f"{R} requests > {M} rows (num_stages={num_stages} × "
            f"batch_per_slot={batch_per_slot}); batch into groups of {M}"
        )
    plen = np.full(R, S, np.int64) if prompt_len is None else np.asarray(prompt_len, np.int64)
    capacity = validate_request(cfg, S, max_new_tokens, capacity)
    check_stage_shapes(cfg, stages)
    temps = np.broadcast_to(np.asarray(temperature, np.float32), (R,))
    topks = np.broadcast_to(np.asarray(top_k, np.int64), (R,))
    topps = np.broadcast_to(
        np.asarray([validate_top_p(p) for p in np.atleast_1d(top_p)], np.float32), (R,)
    )
    seed_arr = np.zeros(R, np.int64) if seeds is None else np.broadcast_to(
        np.asarray(seeds, np.int64), (R,))
    dev = stages[0].device
    gens = {
        r: torch.Generator(device=dev).manual_seed(int(seed_arr[r]))
        for r in range(R) if temps[r] > 0
    }
    sel = sorted(gens)

    def pick(h):  # [R, H] -> [R] int32 on the first device
        ids, full = sp_head(cfg, stages, h, sel)
        for j, r in enumerate(sel):
            ids[r] = sample(full[j : j + 1], float(temps[r]), int(topks[r]), float(topps[r]),
                            generator=gens[r])[0]
        return ids

    res = chain_generate(cfg, stages, prompts, plen, max_new_tokens, capacity, pick)
    return InterleavedResult(res.tokens, res.lengths)
