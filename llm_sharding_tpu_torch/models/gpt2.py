"""GPT-2 causal LM: the port of ``llm_sharding_tpu/models/gpt2.py:35-262``.

Parameters are plain dicts of tensors in the JAX package's layout, so the
two packages share shard stores::

    {"embed": [V, H] (wte; the head is tied to it), "pos_embed": [P, H],
     "layers": [ {ln1_w, ln1_b, w_qkv [H, 3H], b_qkv, w_proj, b_proj,
                  ln2_w, ln2_b, w_fc [H, I], b_fc, w_out [I, H], b_out}, ...],
     "final_norm": [H], "final_norm_bias": [H]}

Positions come from the learned ``pos_embed`` table added at embed time,
so nothing positional happens inside the layers. Attention is multi-head
(one KV head per query head) and goes through the same paths as the llama
family's: the flash kernel for dense prefill, the chunked-prefill and
decode kernels over the paged arena (``models/llama.paged_attn_fn``).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.norms import layer_norm
from ..ops.quant import embed_rows, head_logits, out_dim, qmatmul, tied_logits
from ..utils.convert import params_from_numpy  # noqa: F401 - the JAX tree → port params
from .cache import KVCache
from .config import ModelConfig
from .llama import dense_attn_fn, paged_attn_fn, rows_attn_fn
from .stack import per_shard, replicated, scan_layers, scan_layers_paged, tp_reduce

Params = dict[str, Any]


def init_params(
    cfg: ModelConfig,
    generator: Optional[torch.Generator] = None,
    *,
    seed: int = 0,
    dtype=torch.bfloat16,
    device=None,
) -> Params:
    """Random weights (the ``gpt2.py:35-70`` recipe: normal / sqrt(fan_in)
    weights and tables, 0.02-scaled positions, unit norms, zero biases)
    drawn in f32 from ``generator``, or from a fresh generator seeded with
    ``seed`` on ``device`` (default the GPU)."""
    dev = resolve_device(device)
    gen = generator or torch.Generator(device=dev).manual_seed(seed)
    V, H, I = cfg.vocab_size, cfg.hidden_size, cfg.intermediate_size
    P = cfg.max_position_embeddings

    def normal(*shape, std):
        return (torch.randn(shape, generator=gen, dtype=torch.float32, device=dev) * std).to(dtype)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=dev)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=dev)

    params = {
        "embed": normal(V, H, std=H ** -0.5),
        "pos_embed": normal(P, H, std=0.02),
    }
    params["layers"] = [
        {
            "ln1_w": ones(H), "ln1_b": zeros(H),
            "w_qkv": normal(H, 3 * H, std=H ** -0.5), "b_qkv": zeros(3 * H),
            "w_proj": normal(H, H, std=H ** -0.5), "b_proj": zeros(H),
            "ln2_w": ones(H), "ln2_b": zeros(H),
            "w_fc": normal(H, I, std=H ** -0.5), "b_fc": zeros(I),
            "w_out": normal(I, H, std=I ** -0.5), "b_out": zeros(H),
        }
        for _ in range(cfg.num_hidden_layers)
    ]
    params["final_norm"] = ones(H)
    params["final_norm_bias"] = zeros(H)
    return params


def embed(
    cfg: ModelConfig, params: Params, token_ids: torch.Tensor, positions: torch.Tensor
) -> torch.Tensor:
    """``wte[ids] + wpe[positions]``. Padded query slots carry the position
    sentinel ``2**30``; JAX's gather clamps such an index to the table's
    last row, and so does this (torch would raise, or assert on the
    device). The wte table may be row-quantized; wpe is raw."""
    P = params["pos_embed"].shape[0]
    pos = positions.long().clamp(0, P - 1)
    return embed_rows(params["embed"], token_ids) + params["pos_embed"][pos]


def attn_mlp_block(
    cfg: ModelConfig,
    p: Params,  # a layer's params, or their ``Shards`` over a tensor group
    h: torch.Tensor,  # [B, S, H]
    attn_fn,  # (q [B,S,Nh,D], k [B,S,Nh,D], v [B,S,Nh,D]) -> [B,S,Nh,D]; Shards per shard
) -> torch.Tensor:
    """One GPT-2 block with the attention mechanism injected
    (``gpt2.py:73-129``): pre-LayerNorm, fused qkv, tanh-GELU in f32 cast
    back before ``w_out``; every bias added after its product.

    Over a tensor group each shard holds its slice of the PERMUTED fused
    qkv (``parallel/tensor.permute_gpt2_tp_layers``: ``[q_j | k_j | v_j]``),
    so the local three-way split is the shard's heads; the ``w_proj`` and
    ``w_out`` partials are summed by ``tp_reduce`` and ``b_proj`` /
    ``b_out`` added once, after the reduce."""

    def attn(q_p, hh, j):
        return attn_proj(cfg, q_p, (attn_fn if j is None else attn_fn[j])(*qkv(cfg, q_p, hh)))

    return block_finish(cfg, p, h, tp_reduce(p, h, attn))


def qkv(cfg: ModelConfig, p: Params, h, cos=None, sin=None) -> tuple:
    """ln1 and the fused qkv of one shard, split into its heads (nothing
    positional: ``cos`` / ``sin`` are taken for the llama signature). The
    kernels take contiguous queries; k and v are copied into the cache."""
    B, S, _ = h.shape
    D = cfg.head_dim_
    Nh = out_dim(p["w_qkv"]) // (3 * D)
    x = layer_norm(h, p["ln1_w"], p["ln1_b"], cfg.layer_norm_epsilon)
    qkv_ = qmatmul(x, p["w_qkv"]) + p["b_qkv"]
    q, k, v = (t.reshape(B, S, Nh, D) for t in qkv_.chunk(3, dim=-1))
    return q.contiguous(), k, v


def attn_proj(cfg: ModelConfig, p: Params, attn) -> torch.Tensor:
    """The ``w_proj`` product of one shard's attention output."""
    B, S, Nh, D = attn.shape
    return qmatmul(attn.reshape(B, S, Nh * D), p["w_proj"])


def block_finish(cfg: ModelConfig, p: Params, h, attn_out) -> torch.Tensor:
    """The block after its attention: residual + ``b_proj``, then ln2, the
    MLP (its ``w_out`` partials summed over a tensor group) and
    ``b_out``."""
    h = h + attn_out + replicated(p, "b_proj")
    mlp = tp_reduce(p, h, lambda q_p, hh, j: _mlp_partial(cfg, q_p, hh))
    return h + mlp + replicated(p, "b_out")


def _mlp_partial(cfg: ModelConfig, p: Params, h) -> torch.Tensor:
    """ln2, ``w_fc`` + GELU and the ``w_out`` product of one shard."""
    x = layer_norm(h, p["ln2_w"], p["ln2_b"], cfg.layer_norm_epsilon)
    mlp = F.gelu((qmatmul(x, p["w_fc"]) + p["b_fc"]).float(), approximate="tanh")
    return qmatmul(mlp.to(x.dtype), p["w_out"])


def decoder_layer(
    cfg: ModelConfig,
    p: Params,
    h: torch.Tensor,  # [B, S, H]
    k_row: torch.Tensor,  # [B, C, Nh, D] this layer's cache row, written in place
    v_row: torch.Tensor,
    positions: torch.Tensor,  # [B, S]
    kv_positions: torch.Tensor,  # [B, C], this step's positions already recorded
    length: int,  # write offset of this step's keys
) -> torch.Tensor:
    return attn_mlp_block(cfg, p, h, per_shard(
        dense_attn_fn, k_row, v_row, positions, kv_positions, length,
    ))


def forward_layers(
    cfg: ModelConfig,
    layers: list,
    h: torch.Tensor,
    cache: KVCache,
    positions: torch.Tensor,
    layer_mask: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, KVCache]:
    def apply(p, h, k_row, v_row, kv_pos, length):
        return decoder_layer(cfg, p, h, k_row, v_row, positions, kv_pos, length)

    return scan_layers(layers, h, cache, positions, apply, layer_mask)


def forward_layers_paged(
    cfg: ModelConfig,
    layers: list,
    h: torch.Tensor,
    k_arena: torch.Tensor,  # [L, NB, BS, Nh, D]
    v_arena: torch.Tensor,
    block_table: torch.Tensor,  # [B, T]
    cols: torch.Tensor,  # [B, S]
    kv_positions: torch.Tensor,  # [B, T * BS]
    positions: torch.Tensor,  # [B, S]
    layer_mask: Optional[torch.Tensor] = None,
    prefill: bool = False,
    nlive: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,  # [L, NB, Nh] f32, quantized arena
    v_scale: Optional[torch.Tensor] = None,
    backend: str = "auto",
) -> torch.Tensor:
    """Paged counterpart of ``forward_layers`` (``gpt2.py:165-240``): the
    same contract as ``llama.forward_layers_paged``."""

    def apply(p, valid, h, k_l, v_l, ks_l, vs_l):
        return attn_mlp_block(cfg, p, h, per_shard(
            paged_attn_fn, k_l, v_l, block_table, cols, positions, kv_positions, prefill, nlive,
            ks_l, vs_l, backend, valid,
        ))

    return scan_layers_paged(layers, h, k_arena, v_arena, apply, layer_mask, k_scale, v_scale)


def forward_layers_rows(
    cfg: ModelConfig,
    layers: list,
    h: torch.Tensor,
    k_cache: torch.Tensor,  # [L, M, C, Nh, D]
    v_cache: torch.Tensor,
    rowsel: torch.Tensor,  # [M, 1]
    cols: torch.Tensor,  # [M, S]
    kv_positions: torch.Tensor,  # [M, C]
    positions: torch.Tensor,  # [M, S]
    live: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dense serve-step layers: the contract of
    ``llama.forward_layers_rows``."""
    for i, p in enumerate(layers):
        h = attn_mlp_block(cfg, p, h, per_shard(
            rows_attn_fn, k_cache[i], v_cache[i], rowsel, cols, positions, kv_positions, live,
        ))
    return h


def final_logits(cfg: ModelConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    """Final LayerNorm + head, fp32 logits; GPT-2 ties the head to wte."""
    h = layer_norm(h, params["final_norm"], params["final_norm_bias"], cfg.layer_norm_epsilon)
    if "lm_head" in params:
        return head_logits(h, params["lm_head"])
    return tied_logits(h, params["embed"])


def forward(
    cfg: ModelConfig,
    params: Params,
    token_ids: torch.Tensor,  # [B, S]
    cache: KVCache,  # updated in place
    positions: torch.Tensor,  # [B, S] int32
) -> tuple[torch.Tensor, KVCache]:
    """Full-model step: embed → layers → fp32 logits ``[B, S, V]``."""
    h = embed(cfg, params, token_ids, positions)
    h, cache = forward_layers(cfg, params["layers"], h, cache, positions)
    return final_logits(cfg, params, h), cache
