"""Single-host autoregressive generation, the port's oracle (counterpart of
``llm_sharding_tpu/runtime/generate.py:280-356``).

Prefill the (right-padded) prompts through the model family's dense
forward (``parallel/pipeline.model_fns``), then one
decode step per token until every row hit a stop id or the budget. Greedy
by default; temperature/top-k/top-p sampling draws its Gumbel noise from
one ``torch.Generator`` seeded with ``seed``. Output layout is the JAX
package's: ``tokens [B, S + max_new]`` (zeros after a row stops) and
``lengths [B]`` (prompt + generated, the stop token included).

``prompt_len + max_new_tokens`` must fit the cache capacity and the model's
position limit; that is checked before any work (``generate.py:12-15``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.cache import POS_SENTINEL, KVCache, init_cache
from ..models.config import ModelConfig
from ..ops.quant import act_dtype, base
from ..ops.sampling import is_stop, sample, validate_top_p
from ..parallel.pipeline import model_fns


class GenerateResult(NamedTuple):
    tokens: np.ndarray  # [B, S + max_new] int32, zeros after a row stops
    lengths: np.ndarray  # [B] prompt + generated (stop token included)
    cache: KVCache


def validate_totals(cfg: ModelConfig, S: int, max_new_tokens: int, capacity: int) -> None:
    total = S + max_new_tokens
    if total > capacity:
        raise ValueError(
            f"prompt ({S}) + max_new_tokens ({max_new_tokens}) exceeds KV cache "
            f"capacity ({capacity}); raise capacity or shorten the request"
        )
    if total > cfg.max_position_embeddings:
        raise ValueError(
            f"requested {total} positions > max_position_embeddings "
            f"({cfg.max_position_embeddings})"
        )


def generate(
    cfg: ModelConfig,
    params: dict,
    prompt_ids,  # [B, S] right-padded, or [S]
    max_new_tokens: int = 128,
    *,
    prompt_len=None,  # [B] real lengths (default: all S)
    capacity: Optional[int] = None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    seed: int = 0,
) -> GenerateResult:
    """Runs on the device the weights live on; the KV cache takes the
    weights' compute dtype (a quantized table's scale dtype)."""
    device = base(params["embed"]).device
    forward = model_fns(cfg).forward
    prompt = np.asarray(prompt_ids, np.int32)
    if prompt.ndim == 1:
        prompt = prompt[None]
    B, S = prompt.shape
    plen = np.full(B, S, np.int64) if prompt_len is None else np.asarray(prompt_len, np.int64)
    capacity = capacity or S + max_new_tokens
    validate_totals(cfg, S, max_new_tokens, capacity)
    top_p = validate_top_p(top_p)
    temperature = float(temperature)
    gen = (
        torch.Generator(device=device).manual_seed(int(seed)) if temperature > 0 else None
    )

    def pick(logits):
        return sample(logits, temperature, int(top_k), top_p, generator=gen)

    cache = init_cache(cfg, B, capacity, dtype=act_dtype(params["embed"]), device=device)
    idx = np.arange(S)[None, :]
    positions = np.where(idx < plen[:, None], idx, POS_SENTINEL).astype(np.int32)
    ids = torch.from_numpy(prompt).to(device)
    logits, cache = forward(cfg, params, ids, cache, torch.from_numpy(positions).to(device))
    rows = torch.arange(B, device=device)
    last = logits[rows, torch.from_numpy(plen - 1).to(device)]
    tok = pick(last)

    out = np.zeros((B, S + max_new_tokens), np.int32)
    out[:, :S] = prompt
    tok_h = tok.cpu().numpy()
    out[np.arange(B), plen] = tok_h
    done = is_stop(cfg, tok).cpu().numpy()
    lengths = plen + 1
    pos = plen.copy()
    for _ in range(1, max_new_tokens):
        if done.all():
            break
        step_pos = torch.from_numpy(pos[:, None].astype(np.int32)).to(device)
        logits, cache = forward(cfg, params, tok[:, None], cache, step_pos)
        nxt = pick(logits[:, 0])
        nxt = torch.where(torch.from_numpy(done).to(device), torch.zeros_like(nxt), nxt)
        pos = pos + 1
        nxt_h = nxt.cpu().numpy()
        out[np.arange(B), pos] = nxt_h
        lengths = np.where(done, lengths, lengths + 1)
        done = done | is_stop(cfg, nxt).cpu().numpy()
        tok = nxt
    return GenerateResult(out, lengths.astype(np.int32), cache)
