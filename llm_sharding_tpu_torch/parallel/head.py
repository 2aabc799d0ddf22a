"""The embedding and the LM head sharded by vocab over the pipeline stages
(the port of ``llm_sharding_tpu/parallel/head.py``).

Each stage holds a contiguous ``ceil(V / S)``-row slice of the embedding
table (and of ``lm_head`` when untied), padded with zero rows up to ``S``
slices; the small leaves (norms, GPT-2's ``pos_embed``) are on every
stage. So:

- ``sp_embed``: each stage looks its own ids up (the others masked to
  zero), and the partial rows are summed along the chain onto stage 0's
  device, where the chain starts; GPT-2 adds ``pos_embed``, gemma scales
  by ``sqrt(H)``;
- ``sp_next_token``: each stage takes the final norm and its own ``[B,
  V/S]`` logit slice (pad columns at -inf), and the greedy id comes from
  the per-shard (max, argmax) pairs: the lowest stage wins a tie, which is
  the lowest vocab id, as ``argmax`` over the whole vocab picks;
- ``sp_logits``: the shards' logits gathered onto stage 0's device, for
  the rows that sample (and nothing else: greedy rows never gather the
  vocab). A sampled row then draws exactly as on one stage, from its own
  ``torch.Generator``; the JAX package's sliced Gumbel field draws from
  ``jax.random`` instead, which the port never matched.

The functions take the chain's stages (``parallel/pipeline.Stage``:
``device``, ``head``, ``lo``); a tensor hops between devices with a
``non_blocking`` copy, a no-op where two stages share a device.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..device import device_const, hop
from ..models.config import ModelConfig
from ..ops.norms import layer_norm, rms_norm
from ..ops.quant import QTensor, base, embed_rows, head_logits, tied_logits

# keys sharded over the vocab (stacked [num_stages, ...] by shard_head_host)
VOCAB_SHARDED = ("embed", "lm_head")

HeadParams = dict[str, Any]


def vocab_shard_size(vocab_size: int, num_stages: int) -> int:
    """Per-stage vocab rows (the vocab padded up to a multiple of the
    stage count)."""
    return -(-vocab_size // num_stages)


def shard_head_host(cfg: ModelConfig, head_host: HeadParams, num_stages: int) -> HeadParams:
    """Stack the vocab shards: ``embed [V, H] → [S, V/S, H]``, ``lm_head
    [H, V] → [S, H, V/S]``, a quantized table's per-vocab scale ``[V] →
    [S, V/S]``, zero pad rows (columns) past the vocab; the other leaves
    pass through. Host tensors in, host tensors out (``head.py:60``)."""
    Vs = vocab_shard_size(cfg.vocab_size, num_stages)
    pad = Vs * num_stages - cfg.vocab_size

    def shard_embed(v):  # [V, H] -> [S, V/S, H]
        if pad:
            v = torch.cat([v, v.new_zeros((pad, v.shape[1]))])
        return v.reshape(num_stages, Vs, v.shape[1])

    def shard_lm_head(v):  # [H, V] -> [S, H, V/S]
        if pad:
            v = torch.cat([v, v.new_zeros((v.shape[0], pad))], dim=1)
        return v.reshape(v.shape[0], num_stages, Vs).permute(1, 0, 2).contiguous()

    def shard_scale(v):  # [V] -> [S, V/S]
        if pad:
            v = torch.cat([v, v.new_zeros(pad)])
        return v.reshape(num_stages, Vs)

    out: HeadParams = {}
    for k, v in head_host.items():
        fn = shard_embed if k == "embed" else shard_lm_head if k == "lm_head" else None
        if fn is None:
            out[k] = v
        elif isinstance(v, QTensor):  # the scale splits along the codes' vocab axis
            out[k] = type(v)(q=fn(v.q), scale=shard_scale(v.scale))
        else:
            out[k] = fn(v)
    return out


def stage_head(sharded: HeadParams, i: int, device: torch.device) -> HeadParams:
    """Stage ``i``'s head on ``device``: its slice of each vocab-sharded
    leaf, and the replicated leaves (the JAX ``local_view``)."""

    def put(t):
        return t.contiguous().to(device)

    out: HeadParams = {}
    for k, v in sharded.items():
        if k not in VOCAB_SHARDED:
            out[k] = put(v)
        elif isinstance(v, QTensor):
            out[k] = type(v)(q=put(v.q[i]), scale=put(v.scale[i]))
        else:
            out[k] = put(v[i])
    return out


def is_sharded_head(head: HeadParams) -> bool:
    return base(head["embed"]).ndim == 3


def sp_embed(
    cfg: ModelConfig,
    stages: list,
    ids: torch.Tensor,  # [B, S] int, any device
    positions: Optional[torch.Tensor] = None,  # [B, S] (GPT-2's pos_embed)
) -> torch.Tensor:
    """Vocab-parallel embedding → ``[B, S, H]`` on the first stage's
    device: each stage's masked local lookup, summed onto the next stage's
    device along the chain (a row is nonzero on exactly one stage, so the
    sum is exact), then the family's extras (``head.py:145``)."""
    acc = None
    for st in stages:
        table = st.head["embed"]
        Vs = base(table).shape[0]
        local = hop(ids, st.device).long() - st.lo
        ok = (local >= 0) & (local < Vs)
        rows = embed_rows(table, local.clamp(0, Vs - 1))
        zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
        part = torch.where(ok[..., None], rows, zero)
        acc = part if acc is None else hop(acc, st.device) + part
    first = stages[0]
    h = hop(acc, first.device)
    if cfg.model_type == "gpt2":
        pe = first.head["pos_embed"]
        h = h + pe[hop(positions, first.device).long().clamp(0, pe.shape[0] - 1)]
    if cfg.embed_multiplier != 1.0:  # gemma: the hidden state scaled by sqrt(H)
        h = h * device_const(float(cfg.embed_multiplier), h.dtype, h.device)
    return h


def _local_logits(cfg: ModelConfig, st, h: torch.Tensor) -> torch.Tensor:
    """Final norm + stage ``st``'s fp32 logit slice ``[..., V/S]`` on its
    device, the pad columns (past the vocab) at -inf (``head.py:169``)."""
    head = st.head
    h = hop(h, st.device)
    if cfg.model_type == "gpt2":
        x = layer_norm(h, head["final_norm"], head["final_norm_bias"], cfg.layer_norm_epsilon)
    else:
        x = rms_norm(h, head["final_norm"], cfg.rms_norm_eps, cfg.norm_offset)
    if "lm_head" in head:
        logits = head_logits(x, head["lm_head"])
    else:  # tied: against the local embedding slice
        logits = tied_logits(x, head["embed"])
    Vs = logits.shape[-1]
    if st.lo + Vs > cfg.vocab_size:
        col_ok = torch.arange(Vs, device=logits.device) < cfg.vocab_size - st.lo
        logits = logits.masked_fill(~col_ok, float("-inf"))
    return logits


def _assemble_argmax(stages: list, shards: list) -> torch.Tensor:
    """The global argmax over vocab-sharded fp32 values (``shards[s]``
    ``[..., V/S]`` on stage ``s``'s device) → int32 ids ``[...]`` on the
    first stage's device, from the per-shard (max, argmax) pairs. ``argmax``
    over the stages returns the first maximum: on a tie the lowest stage,
    i.e. the lowest vocab id, as the unsharded argmax (``head.py:194``)."""
    dev = stages[0].device
    maxs, args = [], []
    for st, v in zip(stages, shards):
        m, a = v.max(dim=-1)
        maxs.append(hop(m, dev))
        args.append(hop(a + st.lo, dev))
    best = torch.stack(maxs).argmax(dim=0, keepdim=True)
    return torch.stack(args).gather(0, best)[0].to(torch.int32)


def sp_next_token(cfg: ModelConfig, stages: list, h: torch.Tensor) -> torch.Tensor:
    """Greedy next token over the vocab-sharded head (``head.py:207``):
    ``h [..., H]`` → int32 ``[...]`` on the first stage's device."""
    return _assemble_argmax(stages, [_local_logits(cfg, st, h) for st in stages])


def sp_head(cfg: ModelConfig, stages: list, h: torch.Tensor, sel=()) -> tuple:
    """The head of a serve program: the greedy ids of every row of ``h
    [n, ..., H]``, and the full fp32 logits ``[len(sel), ..., V]`` of the
    rows listed in ``sel`` (host ints: the rows that sample; none, no
    gather), both on the first stage's device. The rows are sliced, not
    indexed by a tensor: the program copies nothing from the host."""
    shards = [_local_logits(cfg, st, h) for st in stages]
    ids = _assemble_argmax(stages, shards)
    if not len(sel):
        return ids, None
    dev = stages[0].device
    full = torch.cat(
        [hop(torch.cat([v[i : i + 1] for i in sel]), dev) for v in shards], dim=-1
    )
    return ids, full[..., : cfg.vocab_size]


def sp_logits(cfg: ModelConfig, stages: list, h: torch.Tensor) -> torch.Tensor:
    """Every row's full fp32 logits ``[..., V]``, gathered onto the first
    stage's device."""
    dev = stages[0].device
    full = torch.cat([hop(_local_logits(cfg, st, h), dev) for st in stages], dim=-1)
    return full[..., : cfg.vocab_size]


def head_bytes_per_stage(cfg: ModelConfig, num_stages: int, dtype_bytes: int = 2) -> int:
    """Per-device bytes of the vocab tables under vocab sharding: the
    embedding shard, the ``lm_head`` shard when untied, the final norm."""
    Vs = vocab_shard_size(cfg.vocab_size, num_stages)
    H = cfg.hidden_size
    n = Vs * H
    if not cfg.tie_word_embeddings:
        n += H * Vs
    n += H
    return n * dtype_bytes


def head_bytes_replicated(cfg: ModelConfig, dtype_bytes: int = 2) -> int:
    """Per-device bytes if every stage held the whole head."""
    n = cfg.vocab_size * cfg.hidden_size
    if not cfg.tie_word_embeddings:
        n += cfg.hidden_size * cfg.vocab_size
    n += cfg.hidden_size
    return n * dtype_bytes
