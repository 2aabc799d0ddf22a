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

Decode is segmented (``_run_decode_segments``, JAX ``generate.py:224-277``):
the cache is allocated at full capacity once, and each rung of a ladder of
capacities (256, 1024, 4096, ... up to the capacity) decodes over a view
of the cache's first columns, so a step's attention reads the live
context, not the requested capacity. ``decode_from_cache`` continues from
a prefill made elsewhere (the context-parallel prefill's hand-off).

``speculate=K`` switches to speculative decoding (``runtime/spec.py``,
``generate.py:293-312``); ``speculate=0`` is the loop below, unchanged.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Optional

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


def prefill(cfg: ModelConfig, params: dict, prompt: np.ndarray, plen: np.ndarray,
            cache: KVCache) -> tuple:
    """Prefill the right-padded ``prompt [B, S]`` (real lengths ``plen``)
    into ``cache`` from column 0, padding at the sentinel position; returns
    the logits of each row's last real token ``[B, V]`` and the cache."""
    device = cache.k.device
    B, S = prompt.shape
    idx = np.arange(S)[None, :]
    positions = np.where(idx < plen[:, None], idx, POS_SENTINEL).astype(np.int32)
    ids = torch.from_numpy(prompt).to(device)
    logits, cache = model_fns(cfg).forward(
        cfg, params, ids, cache, torch.from_numpy(positions).to(device)
    )
    rows = torch.arange(B, device=device)
    return logits[rows, torch.from_numpy(plen - 1).to(device)], cache


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
    speculate: int = 0,
    spec_ngram: int = 3,
    spec_burst: int = 4,
) -> GenerateResult:
    """Runs on the device the weights live on; the KV cache takes the
    weights' compute dtype (a quantized table's scale dtype).

    ``speculate=K`` (K >= 1) verifies n-gram self-drafted tokens K + 1 at a
    time per forward pass (``runtime/spec.spec_generate``); greedy output
    equals this loop's. ``spec_ngram`` is the longest suffix the drafter
    matches, ``spec_burst`` the verify steps dispatched per host read."""
    if speculate:
        from .spec import spec_generate

        return spec_generate(
            cfg, params, prompt_ids, max_new_tokens, speculate=speculate,
            spec_ngram=spec_ngram, spec_burst=spec_burst, prompt_len=prompt_len,
            capacity=capacity, temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
        )
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
    last, cache = prefill(cfg, params, prompt, plen, cache)
    return _run_decode_segments(cfg, params, prompt, plen, pick(last), cache, capacity,
                                max_new_tokens, pick)


# Smallest cache capacity a decode segment runs at; rungs quadruple from
# here (JAX ``generate.py:224-226``).
MIN_SEGMENT_CAPACITY = 256
SEGMENT_GROWTH = 4


def _segment_capacities(start_need: int, capacity: int) -> list:
    """The capacity ladder covering ``[start_need, capacity]`` (JAX
    ``generate.py:262-277``, exactly): rungs quadruple from
    ``MIN_SEGMENT_CAPACITY``, a rung is kept only where the capacity at
    least doubles after it, and the last rung is ``capacity``."""
    c = MIN_SEGMENT_CAPACITY
    while c < start_need:
        c *= SEGMENT_GROWTH
    caps = []
    while c < capacity:
        if 2 * c <= capacity:
            caps.append(c)
        c *= SEGMENT_GROWTH
    caps.append(capacity)
    return caps


def _cache_view(cache: KVCache, cap: int) -> KVCache:
    """The first ``cap`` columns of ``cache`` as views (shared storage: what
    a step writes there lands in ``cache``)."""
    return KVCache(k=cache.k[:, :, :cap], v=cache.v[:, :, :cap], pos=cache.pos[:, :cap],
                   length=cache.length)


def _run_decode_segments(cfg: ModelConfig, params: dict, prompt: np.ndarray, plen: np.ndarray,
                         tok: torch.Tensor, cache: KVCache, capacity: int,
                         max_new_tokens: int, pick) -> GenerateResult:
    """The decode tail of ``generate`` and ``decode_from_cache`` (JAX
    ``generate.py:242-259``): ``tok`` is each row's first generated token,
    ``cache`` holds the prompt's ``S`` columns. Each rung of the segment
    ladder attends over the cache view ``[:, :cap]`` only, so a step's
    attention reads the live context, not the requested capacity; a rung
    stops before a write would pass ``cap``, and the loop exits once the
    budget is spent or every row stopped. Masked columns add an exact zero
    to the softmax, so the tokens are those of one full-capacity run."""
    forward = model_fns(cfg).forward
    device = tok.device
    B, S = prompt.shape
    out = np.zeros((B, S + max_new_tokens), np.int32)
    out[:, :S] = prompt
    out[np.arange(B), plen] = tok.cpu().numpy()
    done = is_stop(cfg, tok).cpu().numpy()
    lengths = plen + 1
    pos = plen.copy()
    n = 1
    for cap in _segment_capacities(S + 1, capacity):
        # the write offset after n decode steps is S + n: stop this rung
        # before it would write past cap
        n_limit = min(max_new_tokens, cap - S)
        view = _cache_view(cache, cap)
        while n < n_limit and not done.all():
            step_pos = torch.from_numpy(pos[:, None].astype(np.int32)).to(device)
            logits, view = forward(cfg, params, tok[:, None], view, step_pos)
            nxt = pick(logits[:, 0])
            nxt = torch.where(torch.from_numpy(done).to(device), torch.zeros_like(nxt), nxt)
            pos = pos + 1
            out[np.arange(B), pos] = nxt.cpu().numpy()
            lengths = np.where(done, lengths, lengths + 1)
            done = done | is_stop(cfg, nxt).cpu().numpy()
            tok = nxt
            n += 1
        cache.length = view.length
        if n >= max_new_tokens or done.all():
            break
    return GenerateResult(out, lengths.astype(np.int32), cache)


def decode_from_cache(
    cfg: ModelConfig,
    params: dict,
    prompt_ids,  # [B, S] right-padded, or [S]
    last_logits,  # [B, V] logits of each row's last real token
    cache: KVCache,  # prefilled: slot index == sequence index, length == S
    max_new_tokens: int = 128,
    *,
    prompt_len=None,
    capacity: Optional[int] = None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    seed: int = 0,
    donate_cache: bool = True,
) -> GenerateResult:
    """Continue decoding from a prefill made elsewhere (JAX
    ``generate.py:359-439``), the hand-off of the context-parallel prefill
    (``parallel/context.py``): the first token is drawn from
    ``last_logits``, then one draw per step from one generator seeded with
    ``seed``, the draws of ``generate``, so the two are token-exact on the
    same weights. A cache shorter than ``capacity`` is padded (zeros, the
    position sentinel). ``cache`` is written in place by default;
    ``donate_cache=False`` copies it first, so one prefill can be decoded
    from several times."""
    device = base(params["embed"]).device
    prompt = np.asarray(prompt_ids, np.int32)
    if prompt.ndim == 1:
        prompt = prompt[None]
    B, S = prompt.shape
    plen = np.full(B, S, np.int64) if prompt_len is None else np.asarray(prompt_len, np.int64)
    capacity = max(capacity or S + max_new_tokens, cache.capacity)
    validate_totals(cfg, S, max_new_tokens, capacity)
    if cache.capacity < capacity:  # pad the prefilled cache up to capacity
        pad = capacity - cache.capacity
        k_pad = (0, 0, 0, 0, 0, pad)  # F.pad order: last axis first
        cache = KVCache(
            k=torch.nn.functional.pad(cache.k, k_pad), v=torch.nn.functional.pad(cache.v, k_pad),
            pos=torch.nn.functional.pad(cache.pos, (0, pad), value=POS_SENTINEL),
            length=cache.length,
        )
    elif not donate_cache:
        cache = KVCache(k=cache.k.clone(), v=cache.v.clone(), pos=cache.pos.clone(),
                        length=cache.length)
    top_p = validate_top_p(top_p)
    temperature = float(temperature)
    gen = torch.Generator(device=device).manual_seed(int(seed)) if temperature > 0 else None

    def pick(logits):
        return sample(logits, temperature, int(top_k), top_p, generator=gen)

    tok = pick(torch.as_tensor(last_logits).to(device=device, dtype=torch.float32))
    return _run_decode_segments(cfg, params, prompt, plen, tok, cache, capacity,
                                max_new_tokens, pick)


def generate_stream(
    cfg: ModelConfig,
    params: dict,
    prompt_ids,  # [1, S] or [S]: streaming is per request
    max_new_tokens: int = 128,
    *,
    capacity: Optional[int] = None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    seed: int = 0,
) -> Iterator[int]:
    """Token-by-token decode (JAX ``generate.py:442``): yields each token id
    as it is sampled and stops after a stop id or ``max_new_tokens``. Each
    yield reads one token from the device. Sampling draws from one
    ``torch.Generator`` seeded with ``seed``, so greedy output equals
    ``generate``'s."""
    device = base(params["embed"]).device
    forward = model_fns(cfg).forward
    prompt = np.asarray(prompt_ids, np.int32)
    if prompt.ndim == 1:
        prompt = prompt[None]
    B, S = prompt.shape
    if B != 1:
        raise ValueError("streaming decode is per-request (batch=1)")
    capacity = capacity or (S + max_new_tokens)
    if S + max_new_tokens > capacity:
        raise ValueError("prompt + max_new_tokens exceeds cache capacity")
    top_p = validate_top_p(top_p)
    temperature = float(temperature)
    gen = torch.Generator(device=device).manual_seed(int(seed)) if temperature > 0 else None
    cache = init_cache(cfg, B, capacity, dtype=act_dtype(params["embed"]), device=device)
    logits, cache = forward(
        cfg, params, torch.from_numpy(prompt).to(device),
        cache, torch.arange(S, dtype=torch.int32, device=device)[None],
    )
    last = logits[:, -1]
    stops = set(int(t) for t in cfg.eos_token_ids)
    for i in range(max_new_tokens):
        tok = sample(last, temperature, int(top_k), top_p, generator=gen)
        t = int(tok[0])
        yield t
        if t in stops or i + 1 == max_new_tokens:
            return
        pos = torch.full((B, 1), S + i, dtype=torch.int32, device=device)
        logits, cache = forward(cfg, params, tok[:, None].to(torch.int32), cache, pos)
        last = logits[:, 0]
