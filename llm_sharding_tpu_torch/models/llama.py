"""Llama-family causal LM (Llama-2/3/3.2, qwen2 qkv biases, gemma-1 block
variants): the port of ``llm_sharding_tpu/models/llama.py``.

Parameters are plain dicts of tensors, weights in the JAX package's
``[in, out]`` layout so the two packages share shard stores::

    {"embed": [V, H], "layers": [ {per-layer weights}, ... ],
     "final_norm": [H], "lm_head": [H, V] (untied models only)}

Any matmul weight, and the vocab tables, may be an int8 / int4
``ops/quant.QTensor``: every projection goes through ``qmatmul``, the
embedding through ``embed_rows``, the head through ``head_logits`` /
``tied_logits``.

The layer stack is a Python loop (``models/stack.py``). The dense path
(``forward``) attends through ``ops/flash_attention`` (the flash kernel for
prefill); the paged path (``forward_layers_paged``) through
``ops/paged_attention`` (the decode and chunked-prefill kernels).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..device import device_const, hop, resolve_device
from ..ops.flash_attention import attention_step
from ..ops.norms import rms_norm
from ..ops.paged_attention import (
    combine_attn_stats, paged_attention, paged_prefill, write_block_kv,
)
from ..ops.quant import embed_rows, head_logits, out_dim, qmatmul, tied_logits
from ..ops.rope import apply_rope, rope_cos_sin
from ..utils import convert
from .cache import KVCache
from .config import ModelConfig
from .stack import (
    CpShards, cp_part, per_shard, replicated, scan_layers, scan_layers_paged, tp_reduce,
)

Params = dict[str, Any]


def _require_llama(cfg: ModelConfig) -> None:
    if cfg.model_type != "llama":
        raise ValueError(
            f"model_type {cfg.model_type!r} is not the llama family; "
            "parallel/pipeline.model_fns picks the family's module"
        )


def init_params(
    cfg: ModelConfig,
    generator: Optional[torch.Generator] = None,
    *,
    seed: int = 0,
    dtype=torch.bfloat16,
    device=None,
) -> Params:
    """Random weights (the ``llama.py:45-99`` recipe: normal / sqrt(fan_in),
    unit norms, zero biases) drawn from ``generator``, or from a fresh
    generator seeded with ``seed`` on ``device`` (default the GPU)."""
    _require_llama(cfg)
    dev = resolve_device(device)
    gen = generator or torch.Generator(device=dev).manual_seed(seed)
    H, I, D = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim_
    Nh, Nkv, V = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.vocab_size

    def w(*shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=dev) * shape[-2] ** -0.5

    layers = []
    for _ in range(cfg.num_hidden_layers):
        p = {
            "input_norm": torch.ones(H, dtype=dtype, device=dev),
            "wq": w(H, Nh * D),
            "wk": w(H, Nkv * D),
            "wv": w(H, Nkv * D),
            "wo": w(Nh * D, H),
            "post_norm": torch.ones(H, dtype=dtype, device=dev),
            "w_gate": w(H, I),
            "w_up": w(H, I),
            "w_down": w(I, H),
        }
        if cfg.attention_bias:
            p["bq"] = torch.zeros(Nh * D, dtype=dtype, device=dev)
            p["bk"] = torch.zeros(Nkv * D, dtype=dtype, device=dev)
            p["bv"] = torch.zeros(Nkv * D, dtype=dtype, device=dev)
        layers.append(p)
    params = {
        "embed": (
            torch.randn((V, H), generator=gen, dtype=torch.float32, device=dev) * H ** -0.5
        ).to(dtype),
        "layers": layers,
        "final_norm": torch.ones(H, dtype=dtype, device=dev),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = (
            torch.randn((H, V), generator=gen, dtype=torch.float32, device=dev) * H ** -0.5
        ).to(dtype)
    return params


def params_from_numpy(cfg: ModelConfig, tree: dict, dtype=None, device=None) -> Params:
    """The JAX package's llama params pytree (numpy leaves, layers stacked
    ``[L, ...]``, quantized leaves as its ``QTensor``s) → the port's
    params on ``device``. How the tests feed both packages the same
    weights."""
    _require_llama(cfg)
    return convert.params_from_numpy(cfg, tree, dtype, device)


def attn_mlp_block(
    cfg: ModelConfig,
    p: Params,  # a layer's params, or their ``Shards`` over a tensor group
    h: torch.Tensor,  # [B, S, H]
    cos: torch.Tensor,
    sin: torch.Tensor,
    attn_fn,  # (q [B,S,Nh,D], k [B,S,Nkv,D], v [B,S,Nkv,D]) -> [B,S,Nh,D]; Shards per shard
) -> torch.Tensor:
    """One llama block with the attention mechanism injected
    (``llama.py:113-182``). Projection biases are keyed by presence.

    Over a tensor group (``p`` as ``Shards``: wq/wk/wv/w_gate/w_up
    column-split, wo/w_down row-split, ``parallel/tensor.py``) each shard
    runs the block up to its two row-parallel products on its own heads,
    and ``tp_reduce`` sums their partials where JAX ``psum``s; ``bo`` is
    added once, after the reduce. Head counts come from the weight shapes,
    so a shard sees its ``Nh / tp`` and ``Nkv / tp``."""

    def attn(q_p, hh, j):
        d = hh.device
        q, k, v = qkv(cfg, q_p, hh, hop(cos, d), hop(sin, d))
        return attn_proj(cfg, q_p, (attn_fn if j is None else attn_fn[j])(q, k, v))

    return block_finish(cfg, p, h, tp_reduce(p, h, attn))


def qkv(cfg: ModelConfig, p: Params, h, cos, sin) -> tuple:
    """Norm, the q/k/v projections (biases by presence) and RoPE of one
    shard (the whole layer at tp 1): the attention's operands."""
    B, S, _ = h.shape
    D = cfg.head_dim_
    Nh = out_dim(p["wq"]) // D
    Nkv = out_dim(p["wk"]) // D
    x = rms_norm(h, p["input_norm"], cfg.rms_norm_eps, cfg.norm_offset)
    qx, kx, vx = qmatmul(x, p["wq"]), qmatmul(x, p["wk"]), qmatmul(x, p["wv"])
    if "bq" in p:
        qx = qx + p["bq"]
    if "bk" in p:
        kx = kx + p["bk"]
    if "bv" in p:
        vx = vx + p["bv"]
    q = apply_rope(qx.reshape(B, S, Nh, D), cos, sin)
    k = apply_rope(kx.reshape(B, S, Nkv, D), cos, sin)
    return q, k, vx.reshape(B, S, Nkv, D)


def attn_proj(cfg: ModelConfig, p: Params, attn) -> torch.Tensor:
    """The ``wo`` product of one shard's attention output: the partial the
    tensor group sums."""
    B, S, Nh, D = attn.shape
    return qmatmul(attn.reshape(B, S, Nh * D), p["wo"])


def block_finish(cfg: ModelConfig, p: Params, h, attn_out) -> torch.Tensor:
    """The block after its attention: ``bo`` once on the summed ``wo``
    product, the residual, then the MLP (its ``w_down`` partials summed
    over a tensor group)."""
    bo = replicated(p, "bo")
    if bo is not None:
        attn_out = attn_out + bo
    h = h + attn_out
    return h + tp_reduce(p, h, lambda q_p, hh, j: _mlp_partial(cfg, q_p, hh))


def _mlp_partial(cfg: ModelConfig, p: Params, h) -> torch.Tensor:
    """Post-norm and the gated MLP of one shard, through ``w_down``."""
    x = rms_norm(h, p["post_norm"], cfg.rms_norm_eps, cfg.norm_offset)
    gate = qmatmul(x, p["w_gate"]).float()
    if cfg.hidden_act == "gelu_tanh":
        act = F.gelu(gate, approximate="tanh")
    elif cfg.hidden_act == "silu":
        act = F.silu(gate)
    else:
        raise ValueError(f"unsupported hidden_act {cfg.hidden_act!r}")
    return qmatmul(act.to(x.dtype) * qmatmul(x, p["w_up"]), p["w_down"])


def decoder_layer(
    cfg: ModelConfig,
    p: Params,
    h: torch.Tensor,  # [B, S, H]
    k_row: torch.Tensor,  # [B, C, Nkv, D] this layer's cache row, written in place
    v_row: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    positions: torch.Tensor,  # [B, S]
    kv_positions: torch.Tensor,  # [B, C], this step's positions already recorded
    length: int,  # write offset of this step's keys
) -> torch.Tensor:
    return attn_mlp_block(cfg, p, h, cos, sin, per_shard(
        dense_attn_fn, k_row, v_row, positions, kv_positions, length,
    ))


def dense_attn_fn(k_row, v_row, positions, kv_positions, length: int):
    """The attention of a dense layer (shared by the model families): the
    step's keys land at columns ``[length, length + S)`` of the cache row,
    then the dense dispatch (``ops/flash_attention.attention_step``)."""

    def attn_fn(q, k, v):
        S = q.shape[1]
        k_row[:, length : length + S] = k.to(k_row.dtype)
        v_row[:, length : length + S] = v.to(v_row.dtype)
        return attention_step(q, k_row, v_row, positions, kv_positions)

    return attn_fn


def paged_decoder_layer(
    cfg: ModelConfig,
    p: Params,
    h: torch.Tensor,  # [B, S, H]
    k_arena: torch.Tensor,  # [NB, BS, Nkv, D] this layer's blocks, written in place
    v_arena: torch.Tensor,
    block_table: torch.Tensor,  # [B, T] int32
    cols: torch.Tensor,  # [B, S] logical columns of this step's entries
    cos: torch.Tensor,
    sin: torch.Tensor,
    positions: torch.Tensor,  # [B, S] int32
    kv_positions: torch.Tensor,  # [B, T * BS] int32, this step's already recorded
    prefill: bool = False,  # chunk-shaped queries: the chunked-prefill kernel
    nlive: Optional[torch.Tensor] = None,  # [B] blocks covering each row's written frontier
    k_scale: Optional[torch.Tensor] = None,  # [NB, Nkv] f32, quantized arena, in place
    v_scale: Optional[torch.Tensor] = None,
    backend: str = "auto",  # ops/paged_attention.BACKENDS
    valid: Optional[torch.Tensor] = None,  # scalar bool: False leaves the arena as it was
) -> torch.Tensor:
    """Layer over the pooled arena (``llama.py:208-293``): the step's fresh
    KV lands by a block-indexed scatter (quantized at insert against the
    running block scales when the arena holds codes), then attention
    streams exactly the blocks the table names. Write-then-attend, so
    causality within a chunk falls out of the position mask."""
    return attn_mlp_block(cfg, p, h, cos, sin, per_shard(
        paged_attn_fn, k_arena, v_arena, block_table, cols, positions, kv_positions, prefill,
        nlive, k_scale, v_scale, backend, valid,
    ))


def paged_attn_fn(
    k_arena, v_arena, block_table, cols, positions, kv_positions, prefill, nlive,
    k_scale, v_scale, backend, valid,
):
    """The attention of a paged layer, shared by the model families:
    scatter the fresh K/V (gated by ``valid``), then the chunked-prefill
    kernel for chunk-shaped queries or the decode kernel. An arena of
    ``CpShards`` is a context-parallel one (``cp_attn_fn``)."""
    if isinstance(k_arena, CpShards):
        return cp_attn_fn(
            k_arena, v_arena, block_table, cols, positions, kv_positions, prefill, nlive,
            k_scale, v_scale, backend, valid,
        )
    qkw = dict(k_scale=k_scale, v_scale=v_scale)

    def attn_fn(q, k, v):
        write_block_kv(k_arena, v_arena, block_table, cols, k, v, valid=valid, **qkw)
        if prefill:
            return paged_prefill(
                q, k_arena, v_arena, block_table, positions, kv_positions, nlive=nlive,
                backend=backend, **qkw,
            )
        return paged_attention(
            q, k_arena, v_arena, block_table, positions, kv_positions, nlive=nlive,
            backend=backend, **qkw,
        )

    return attn_fn


def cp_attn_fn(
    k_arena, v_arena, block_table, cols, positions, kv_positions, prefill, nlive,
    k_scale, v_scale, backend, valid,
):
    """The attention of a context-parallel paged layer (JAX ``llama.py:
    208-280`` with ``cp_axis``): ``k_arena`` / ``v_arena`` (and the scales)
    are ``CpShards``, one arena per shard of the group, and ``block_table``
    the shards' planes of LOCAL block ids, where a column another shard owns
    maps to the shard's trash block 0. Each shard writes the step's fresh
    KV through its own plane (owned columns land in its blocks, the rest in
    its trash), then attends its blocks in stats mode, and
    ``combine_attn_stats`` merges the shards' ``(acc, m, l)`` on the first
    shard's device: attention over the whole window. The projections
    around it run once, on that device."""
    fn = paged_prefill if prefill else paged_attention

    def attn_fn(q, k, v):
        d0 = q.device
        parts = []
        for s, d in enumerate(k_arena.devices):
            ka, va, tbl = k_arena.parts[s], v_arena.parts[s], block_table.parts[s]
            qkw = dict(k_scale=cp_part(k_scale, s), v_scale=cp_part(v_scale, s))
            write_block_kv(ka, va, tbl, hop(cols, d), hop(k, d), hop(v, d),
                           valid=None if valid is None else hop(valid, d), **qkw)
            parts.append(tuple(hop(x, d0) for x in fn(
                hop(q, d), ka, va, tbl, hop(positions, d), hop(kv_positions, d),
                nlive=None if nlive is None else hop(nlive, d), backend=backend, stats=True,
                **qkw,
            )))
        acc, m, l = (torch.stack(x) for x in zip(*parts))
        return combine_attn_stats(acc, m, l).to(q.dtype)

    return attn_fn


def rows_attn_fn(k_row, v_row, rowsel, cols, positions, kv_positions, live):
    """The attention of a dense serving layer whose rows write at their own
    columns (a serve step: each row's write offset differs), shared by the
    model families. ``k_row`` / ``v_row`` ``[M, C, Nkv, D]`` are the
    layer's slices of the server's dense cache, written in place at
    ``[rowsel, cols]`` (``rowsel`` ``[M, 1]``, ``cols`` ``[M, S]``). A row
    that is not ``live`` writes back the bytes it read, a select with no
    boolean-mask index, so the step keeps one shape and no host read. Then
    the dense dispatch: the flash kernel for S > 1, the plain path at S =
    1, as in JAX (``ops/flash_attention.py:241-244``)."""

    def attn_fn(q, k, v):
        new_k, new_v = k.to(k_row.dtype), v.to(v_row.dtype)
        if live is not None:
            gate = live[:, None, None, None]
            new_k = torch.where(gate, new_k, k_row[rowsel, cols])
            new_v = torch.where(gate, new_v, v_row[rowsel, cols])
        k_row[rowsel, cols] = new_k
        v_row[rowsel, cols] = new_v
        return attention_step(q, k_row, v_row, positions, kv_positions)

    return attn_fn


def forward_layers(
    cfg: ModelConfig,
    layers: list,
    h: torch.Tensor,
    cache: KVCache,
    positions: torch.Tensor,
    layer_mask: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, KVCache]:
    cos, sin = rope_cos_sin(positions, cfg)

    def apply(p, h, k_row, v_row, kv_pos, length):
        return decoder_layer(cfg, p, h, k_row, v_row, cos, sin, positions, kv_pos, length)

    return scan_layers(layers, h, cache, positions, apply, layer_mask)


def forward_layers_paged(
    cfg: ModelConfig,
    layers: list,
    h: torch.Tensor,
    k_arena: torch.Tensor,  # [L, NB, BS, Nkv, D]
    v_arena: torch.Tensor,
    block_table: torch.Tensor,  # [B, T]
    cols: torch.Tensor,  # [B, S]
    kv_positions: torch.Tensor,  # [B, T * BS]
    positions: torch.Tensor,  # [B, S]
    layer_mask: Optional[torch.Tensor] = None,  # [L] bool, padded stages
    prefill: bool = False,
    nlive: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,  # [L, NB, Nkv] f32, quantized arena
    v_scale: Optional[torch.Tensor] = None,
    backend: str = "auto",
) -> torch.Tensor:
    """Paged counterpart of ``forward_layers`` for the serve path: each
    layer scatters into and attends from its arena slice (and its scale
    slice, for a quantized arena), in place; key position bookkeeping
    stays with the caller."""
    cos, sin = rope_cos_sin(positions, cfg)

    def apply(p, valid, h, k_l, v_l, ks_l, vs_l):
        return paged_decoder_layer(
            cfg, p, h, k_l, v_l, block_table, cols, cos, sin, positions, kv_positions,
            prefill, nlive, ks_l, vs_l, backend, valid,
        )

    return scan_layers_paged(layers, h, k_arena, v_arena, apply, layer_mask, k_scale, v_scale)


def forward_layers_rows(
    cfg: ModelConfig,
    layers: list,
    h: torch.Tensor,  # [M, S, H]
    k_cache: torch.Tensor,  # [L, M, C, Nkv, D] the server's dense cache, in place
    v_cache: torch.Tensor,
    rowsel: torch.Tensor,  # [M, 1] int64 row index
    cols: torch.Tensor,  # [M, S] each row's write columns
    kv_positions: torch.Tensor,  # [M, C], this step's positions already recorded
    positions: torch.Tensor,  # [M, S]
    live: Optional[torch.Tensor] = None,  # [M] bool: False rows write nothing
) -> torch.Tensor:
    """Dense counterpart of ``forward_layers_paged`` for the serve steps
    (decode and verify over every row of a dense server): each row writes
    its fresh KV at its own columns, then attends its whole cache row.
    Key-position bookkeeping stays with the caller."""
    cos, sin = rope_cos_sin(positions, cfg)
    for i, p in enumerate(layers):
        h = attn_mlp_block(cfg, p, h, cos, sin, per_shard(
            rows_attn_fn, k_cache[i], v_cache[i], rowsel, cols, positions, kv_positions, live,
        ))
    return h


def final_logits(cfg: ModelConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    """Final norm + head, fp32 logits; a tied model projects against the
    embedding table."""
    h = rms_norm(h, params["final_norm"], cfg.rms_norm_eps, cfg.norm_offset)
    if "lm_head" in params:
        return head_logits(h, params["lm_head"])
    return tied_logits(h, params["embed"])


def embed(
    cfg: ModelConfig,
    params: Params,
    token_ids: torch.Tensor,
    positions: Optional[torch.Tensor] = None,  # unused: RoPE is inside the layers
) -> torch.Tensor:
    """Token embedding with the family's multiplier (gemma: sqrt(H)),
    which the JAX package applies in ``forward`` instead. The table may be
    row-quantized (``ops/quant.embed_rows``)."""
    h = embed_rows(params["embed"], token_ids)
    if cfg.embed_multiplier != 1.0:
        h = h * device_const(float(cfg.embed_multiplier), h.dtype, h.device)
    return h


def forward(
    cfg: ModelConfig,
    params: Params,
    token_ids: torch.Tensor,  # [B, S]
    cache: KVCache,  # updated in place
    positions: torch.Tensor,  # [B, S] int32
) -> tuple[torch.Tensor, KVCache]:
    """Full-model step: embed → layers → fp32 logits ``[B, S, V]``."""
    _require_llama(cfg)
    h = embed(cfg, params, token_ids, positions)
    h, cache = forward_layers(cfg, params["layers"], h, cache, positions)
    return final_logits(cfg, params, h), cache
