"""Speculative decoding: n-gram self-drafting and batched verification (the
port of ``llm_sharding_tpu/runtime/spec.py``).

Drafts come from the longest suffix match against the request's own prompt
and generated ids (prompt-lookup decoding): no draft model. One forward
pass verifies the pending token and up to K drafts at once, and a
variable number of tokens commits per row per pass.

Pieces, each shared by both decode paths as in the JAX package:

- ``ngram_draft`` (``spec.py:79``), the host-side drafter, and
  ``AdaptiveK`` (``:103``), the per-row draft-width controller;
- the device math on tensors: ``_leading_true_count`` (``:125``),
  ``_positionwise_stop`` (``:130``), ``rejection_commit`` (``:139``) and
  ``cap_commits`` (``:181``); ``count_accepted`` (``:210``) on the host;
- the metric families ``spec_drafted_total``, ``spec_accepted_total``,
  ``spec_acceptance_rate`` and ``spec_tokens_per_step`` (``:49-76``), in
  the port's registry under the JAX names and buckets;
- ``spec_generate`` (``:368``) with its verify step ``_spec_verify_step``
  (``:228``): ``runtime/generate.generate(speculate=K)``. The serving path
  (``parallel/serve.serve_verify`` under ``runtime/server.PipelineServer``)
  uses the rest.

KV bookkeeping of ``spec_generate``: the dense cache holds ``capacity +
K + 1`` columns. The verify forward writes its K + 1 entries into the
scratch columns at the top (on CUDA that pass runs the flash kernel at S =
K + 1); the entries are then copied to each row's position-aligned columns
and only the accepted prefix keeps its key positions, the rest and the
scratch columns getting the sentinel. Rollback is a position rewind.

Greedy rows accept by exact leading match against the model's own argmax
choices, so the output equals the non-speculative loop's. Sampled rows
accept a draft with its probability under the filtered target and
otherwise resample with the draft masked out, which keeps the target
distribution. Their draws come from a ``torch.Generator``; torch cannot
reproduce JAX's threefry draws, so ``rejection_commit`` takes its uniforms
and Gumbel noise as arguments, as the JAX function does, and the parity
tests inject the same draws into both.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.cache import POS_SENTINEL, KVCache, init_cache
from ..models.config import ModelConfig
from ..obs.metrics import REGISTRY
from ..ops.quant import act_dtype, base
from ..ops.sampling import filter_rows, gumbel, is_stop, sample, validate_top_p
from ..parallel.pipeline import model_fns

M_SPEC_DRAFTED = REGISTRY.counter(
    "spec_drafted_total",
    "Draft tokens proposed by the n-gram drafter (both decode paths)",
)
M_SPEC_ACCEPTED = REGISTRY.counter(
    "spec_accepted_total",
    "Draft tokens accepted by verification (both decode paths)",
)
M_SPEC_ACC_RATE = REGISTRY.histogram(
    "spec_acceptance_rate",
    "Per-verify-step fraction of drafted tokens accepted (rows with a "
    "non-empty draft only)",
    buckets=(0.1, 0.25, 0.5, 0.75, 0.9, 1.0),
)
M_SPEC_TOKENS_PER_STEP = REGISTRY.histogram(
    "spec_tokens_per_step",
    "Tokens committed per row per verify step (1 = speculation idle, "
    "K+1 = full acceptance)",
    buckets=(1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0),
)


def ngram_draft(ids: np.ndarray, k: int, n: int = 3) -> np.ndarray:
    """Up to ``k`` continuation tokens for one row by longest-suffix match:
    the largest g <= n whose trailing g-gram occurred earlier in ``ids``
    wins, and the tokens after its most recent earlier occurrence are the
    draft. int32, possibly empty (no suffix recurs, or k == 0)."""
    ids = np.asarray(ids, np.int64).reshape(-1)
    L = ids.shape[0]
    if k <= 0 or L < 2:
        return np.zeros((0,), np.int32)
    for g in range(min(n, L - 1), 0, -1):
        pattern = ids[L - g:]
        # windows over ids[:-1]: a match ends before the last token, so the
        # suffix never matches itself and the draft is never empty
        windows = np.lib.stride_tricks.sliding_window_view(ids[:-1], g)
        hits = np.nonzero((windows == pattern).all(axis=1))[0]
        if hits.size:
            start = int(hits[-1]) + g  # the most recent occurrence wins
            return ids[start : start + k].astype(np.int32)
    return np.zeros((0,), np.int32)


class AdaptiveK:
    """Per-row draft width: one more after a fully accepted draft, halved
    after a fully rejected one, within ``[1, k_max]``. The verify runs at
    the fixed width ``k_max``; this only truncates what the drafter
    proposes."""

    __slots__ = ("k_max", "k")

    def __init__(self, k_max: int):
        self.k_max = int(k_max)
        self.k = int(k_max)

    def update(self, drafted: int, accepted: int) -> None:
        if drafted <= 0:
            return
        if accepted >= drafted:
            self.k = min(self.k_max, self.k + 1)
        elif accepted == 0:
            self.k = max(1, self.k // 2)


def _leading_true_count(flags: torch.Tensor) -> torch.Tensor:
    """``[B, K]`` bool → ``[B]`` length of each row's leading all-True run."""
    return torch.cumprod(flags.to(torch.int32), dim=1).sum(dim=1)


def _positionwise_stop(cfg: ModelConfig, toks: torch.Tensor) -> torch.Tensor:
    """``[B, P]`` token grid → ``[B, P]`` bool stop mask."""
    B, P = toks.shape
    return is_stop(cfg, toks.reshape(-1)).reshape(B, P)


def rejection_commit(
    scaled: torch.Tensor,  # [B, K+1, V] filtered temperature-scaled logits
    draft: torch.Tensor,  # [B, K]
    valid_draft: torch.Tensor,  # [B, K] bool
    u: torch.Tensor,  # [B, K] accept uniforms
    g: torch.Tensor,  # [B, K+1, V] Gumbel noise for the resample / bonus
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rejection acceptance against a point-mass (n-gram) proposal: accept
    draft d_i with probability p_i(d_i) under the filtered target; the first
    position not accepted resamples from the target with d masked out.
    Returns ``(a [B], commit [B, K+1])``: the accepted-draft count and the
    commit candidates (positions < a the accepted drafts, position a the
    resample or bonus)."""
    B, K = draft.shape
    V = scaled.shape[-1]
    dev = scaled.device
    draft = draft.to(torch.int64)
    iota = torch.arange(K + 1, device=dev)
    probs = torch.softmax(scaled, dim=-1)
    p_draft = torch.gather(probs[:, :K], -1, draft[..., None])[..., 0]
    acc = valid_draft & (u < p_draft)
    a = _leading_true_count(acc)
    no = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    rejected = torch.cat([valid_draft & ~acc, no], dim=1)
    draft_pad = torch.cat([draft, torch.zeros((B, 1), dtype=torch.int64, device=dev)], dim=1)
    col = torch.arange(V, device=dev)
    hit = rejected[..., None] & (col[None, None, :] == draft_pad[..., None])
    masked = torch.where(hit, torch.full((), float("-inf"), device=dev), scaled)
    resample = (masked + g).argmax(dim=-1)
    commit = torch.where(iota[None, :] < a[:, None], draft_pad, resample)
    return a, commit.to(torch.int32)


def cap_commits(
    cfg: ModelConfig,
    commit: torch.Tensor,  # [B, K+1] commit candidates
    a: torch.Tensor,  # [B] accepted-draft count (run length - 1)
    budget_rem: torch.Tensor,  # [B] tokens the row may still commit
    done: torch.Tensor,  # [B] bool
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cut each row's run at the first stop id inside it, its remaining
    budget and done-ness: the one per-step commit both decode paths share.
    Returns ``(c [B], log [B, K+1] int32 -1-padded, eos_hit [B])``."""
    K1 = commit.shape[1]
    iota = torch.arange(K1, device=commit.device)
    within = iota[None, :] < (a + 1)[:, None]
    eos = _positionwise_stop(cfg, commit) & within
    eos_i = eos.to(torch.int32)
    eos_before = torch.cumsum(eos_i, dim=1) - eos_i
    keep = (
        within & (eos_before == 0) & (iota[None, :] < budget_rem[:, None]) & ~done[:, None]
    )
    c = keep.to(torch.int32).sum(dim=1)
    log = torch.where(keep, commit.to(torch.int32), torch.full((), -1, dtype=torch.int32,
                                                               device=commit.device))
    return c, log, (keep & eos).any(dim=1)


def count_accepted(committed: list, draft, drafted: int) -> int:
    """Accepted drafts in one row's fetched run: the leading match against
    the draft (not ``len(committed) - 1``: a run cut by an accepted stop id
    or the budget has no bonus token)."""
    n = 0
    for i in range(min(len(committed), drafted)):
        if committed[i] != int(draft[i]):
            break
        n += 1
    return n


def observe(drafted: int, accepted: int, committed: int) -> None:
    """One row's verify outcome into the spec metric families."""
    if drafted:
        M_SPEC_DRAFTED.inc(drafted)
        M_SPEC_ACCEPTED.inc(accepted)
        M_SPEC_ACC_RATE.observe(accepted / drafted)
    if committed:
        M_SPEC_TOKENS_PER_STEP.observe(committed)


def _spec_verify_step(
    cfg: ModelConfig,
    params: dict,
    st: dict,  # device state: out, tok, pos, done, lengths (updated in place)
    cache: KVCache,  # capacity + K + 1 columns, updated in place
    budget: torch.Tensor,  # [B] prompt_len + max_new
    draft: torch.Tensor,  # [B, K] right-padded drafts
    draft_len: torch.Tensor,  # [B] valid drafts per row
    K: int,
    temperature: float,
    top_k: int,
    top_p: float,
    generator: Optional[torch.Generator],
) -> torch.Tensor:
    """One forward over ``[tok, d_1..d_K]`` at positions ``pos .. pos + K``,
    then commit each row's accepted run and the model's own next token.
    Returns the ``[B, K+1]`` int32 commit log (-1 padded), left on the
    device: the host's only read, which feeds the next draft."""
    dev = cache.k.device
    scratch = cache.capacity - (K + 1)
    pos0, done0, len0 = st["pos"], st["done"], st["lengths"]
    iota = torch.arange(K + 1, device=dev)
    toks_in = torch.cat([st["tok"][:, None], draft], dim=1)
    positions = torch.where(
        done0[:, None], torch.full((), POS_SENTINEL, device=dev), pos0[:, None] + iota
    ).to(torch.int32)
    cache.length = scratch
    logits, cache = model_fns(cfg).forward(cfg, params, toks_in, cache, positions)
    logits = logits.float()  # [B, K+1, V]

    valid_draft = iota[None, :K] < draft_len[:, None]
    if temperature <= 0.0:
        choices = logits.argmax(dim=-1).to(torch.int32)
        a = _leading_true_count((choices[:, :K] == draft) & valid_draft)
        commit = choices  # commit[i] == draft[i] for i < a; i == a is the bonus
    else:
        B, _, V = logits.shape
        scaled = filter_rows(
            logits / temperature, torch.full((B,), top_k), torch.full((B,), top_p)
        )
        u = torch.rand((B, K), generator=generator, device=dev)
        g = gumbel((B, K + 1, V), generator, dev)
        a, commit = rejection_commit(scaled, draft, valid_draft, u, g)

    c, log, eos_hit = cap_commits(cfg, commit, a, budget - len0, done0)
    lengths = len0 + c
    done = done0 | eos_hit | ((c > 0) & (lengths >= budget))
    last = torch.gather(commit, 1, (c.long() - 1).clamp(0, K)[:, None])[:, 0]
    tok = torch.where(c > 0, last, st["tok"])

    # the committed run lands at out columns pos0 + 1 .. pos0 + c
    out = st["out"]
    rel = torch.arange(out.shape[1], device=dev)[None, :] - (pos0[:, None] + 1)
    in_run = (rel >= 0) & (rel < c[:, None])
    vals = torch.gather(commit, 1, rel.clamp(0, K))
    st["out"] = torch.where(in_run, vals, out)

    # KV rollback: the K+1 scratch entries move to each row's position-
    # aligned columns pos0 .. pos0 + K; only the accepted prefix keeps its
    # key positions, and the scratch columns are rewound. No column at or
    # past the scratch start is ever kept (pos0 + c <= budget - 1 <= capacity - 1).
    chunk_k = cache.k[:, :, scratch:].clone()
    chunk_v = cache.v[:, :, scratch:].clone()
    bidx = torch.arange(len(pos0), device=dev)[:, None]
    cols = pos0[:, None] + iota[None, :]
    cache.k[:, bidx, cols] = chunk_k
    cache.v[:, bidx, cols] = chunk_v
    row_pos = torch.where(
        iota[None, :] < c[:, None], pos0[:, None] + iota[None, :],
        torch.full((), POS_SENTINEL, device=dev),
    )
    cache.pos[bidx, cols] = row_pos.to(torch.int32)
    cache.pos[:, scratch:] = POS_SENTINEL
    cache.length = scratch
    st.update(tok=tok, pos=pos0 + c, done=done, lengths=lengths)
    return log


def spec_generate(
    cfg: ModelConfig,
    params: dict,
    prompt_ids,
    max_new_tokens: int = 128,
    *,
    speculate: int = 4,
    spec_ngram: int = 3,
    spec_burst: int = 4,
    prompt_len=None,
    capacity: Optional[int] = None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    seed: int = 0,
):
    """Speculative generation, ``generate(..., speculate=K)``: draft per row
    on the host, one verify forward over K + 1 positions, the ``[B, K+1]``
    commit log feeds the next draft. Greedy output equals ``generate``'s.

    ``spec_burst`` dispatches that many verify steps per host read
    (``spec.py:452-490``), drafting step t + 1 optimistically from step
    t's assumed full acceptance (the draft plus the n-gram continuation as
    the assumed bonus), and reads the burst's logs at once. A wrong guess
    costs a step that commits one correct token: the verify reads its
    pending token and lengths from the device state, never from the
    draft."""
    from .generate import GenerateResult, prefill, validate_totals

    K = int(speculate)
    if K < 1:
        raise ValueError(f"speculate must be >= 1 on the spec path, got {K}")
    device = base(params["embed"]).device
    prompt = np.asarray(prompt_ids, np.int32)
    if prompt.ndim == 1:
        prompt = prompt[None]
    B, S = prompt.shape
    plen = np.full(B, S, np.int64) if prompt_len is None else np.asarray(prompt_len, np.int64)
    total = S + max_new_tokens
    capacity = capacity or total
    validate_totals(cfg, S, max_new_tokens, capacity)
    top_p = validate_top_p(top_p)
    temperature, top_k = float(temperature), int(top_k)
    gen = (
        torch.Generator(device=device).manual_seed(int(seed)) if temperature > 0 else None
    )

    # K + 1 scratch columns over the requested capacity (module docstring)
    cache = init_cache(cfg, B, capacity + K + 1, dtype=act_dtype(params["embed"]), device=device)
    last, cache = prefill(cfg, params, prompt, plen, cache)
    tok = sample(last, temperature, top_k, top_p, generator=gen)
    plen_t = torch.from_numpy(plen).to(device)
    out = torch.zeros((B, total), dtype=torch.int32, device=device)
    out[:, :S] = torch.from_numpy(prompt).to(device)
    out[torch.arange(B, device=device), plen_t] = tok
    st = dict(out=out, tok=tok, pos=plen_t.clone(), done=is_stop(cfg, tok), lengths=plen_t + 1)
    budget = plen_t + max_new_tokens

    # host mirrors of each row's ids (prompt + commits): the drafter's input
    first = tok.cpu().numpy()
    rows = [list(prompt[b, : plen[b]]) + [int(first[b])] for b in range(B)]
    eos = frozenset(int(t) for t in cfg.eos_token_ids)
    done_h = [int(first[b]) in eos or max_new_tokens <= 1 for b in range(B)]
    gen_count = [1] * B
    kctl = [AdaptiveK(K) for _ in range(B)]
    burst = max(int(spec_burst), 1)

    while not all(done_h):
        # one burst: up to `burst` verifies back to back, each drafted from
        # the previous one's assumed outcome, then one read of all logs
        assumed = [list(r) for r in rows]
        # a burst stops early once every live row's assumed commits reach
        # its budget or a stop id: later verifies could only run done rows
        assumed_done = list(done_h)
        assumed_gen = list(gen_count)
        dispatched = []  # (draft, draft_len) per step
        logs = []
        for _ in range(burst):
            if all(assumed_done):
                break
            draft = np.zeros((B, K), np.int32)
            draft_len = np.zeros((B,), np.int32)
            for b in range(B):
                if done_h[b]:
                    continue
                d = ngram_draft(np.asarray(assumed[b]), kctl[b].k + 1, spec_ngram)
                draft[b, : min(d.shape[0], K)] = d[:K]
                draft_len[b] = min(d.shape[0], kctl[b].k)
                # optimistic: the drafts accept and the (k+1)-th lookup
                # token is the bonus the model picks
                assumed[b].extend(int(t) for t in d)
                assumed_gen[b] += d.shape[0]
                if assumed_gen[b] >= max_new_tokens or any(int(t) in eos for t in d):
                    assumed_done[b] = True
            logs.append(_spec_verify_step(
                cfg, params, st, cache, budget, torch.from_numpy(draft).to(device),
                torch.from_numpy(draft_len).to(device), K, temperature, top_k, top_p, gen,
            ))
            dispatched.append((draft, draft_len))
        for log, (draft, draft_len) in zip(torch.stack(logs).cpu().numpy(), dispatched):
            for b in range(B):
                if done_h[b]:
                    continue
                committed = [int(t) for t in log[b] if t >= 0]
                rows[b].extend(committed)
                gen_count[b] += len(committed)
                drafted = int(draft_len[b])
                accepted = count_accepted(committed, draft[b], drafted)
                kctl[b].update(drafted, accepted)
                observe(drafted, accepted, len(committed))
                if (committed and committed[-1] in eos) or gen_count[b] >= max_new_tokens:
                    done_h[b] = True

    tokens = st["out"].cpu().numpy()
    lengths = st["lengths"].cpu().numpy().astype(np.int32)
    # a cache of the requested capacity (scratch stripped), as generate's
    sliced = KVCache(k=cache.k[:, :, :capacity], v=cache.v[:, :, :capacity],
                     pos=cache.pos[:, :capacity], length=capacity)
    return GenerateResult(tokens, lengths, sliced)
