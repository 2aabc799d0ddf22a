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

from ..device import resolve_device
from ..ops.flash_attention import attention_step
from ..ops.norms import rms_norm
from ..ops.paged_attention import paged_attention, paged_prefill, write_block_kv
from ..ops.quant import embed_rows, head_logits, out_dim, qmatmul, tied_logits
from ..ops.rope import apply_rope, rope_cos_sin
from ..utils import convert
from .cache import KVCache
from .config import ModelConfig
from .stack import scan_layers, scan_layers_paged

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
    p: Params,
    h: torch.Tensor,  # [B, S, H]
    cos: torch.Tensor,
    sin: torch.Tensor,
    attn_fn,  # (q [B,S,Nh,D], k [B,S,Nkv,D], v [B,S,Nkv,D]) -> [B,S,Nh,D]
) -> torch.Tensor:
    """One llama block with the attention mechanism injected
    (``llama.py:113-182``). Projection biases are keyed by presence."""
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
    v = vx.reshape(B, S, Nkv, D)
    attn = attn_fn(q, k, v)
    attn_out = qmatmul(attn.reshape(B, S, Nh * D), p["wo"])
    if "bo" in p:
        attn_out = attn_out + p["bo"]
    h = h + attn_out
    x = rms_norm(h, p["post_norm"], cfg.rms_norm_eps, cfg.norm_offset)
    gate = qmatmul(x, p["w_gate"]).float()
    if cfg.hidden_act == "gelu_tanh":
        act = F.gelu(gate, approximate="tanh")
    elif cfg.hidden_act == "silu":
        act = F.silu(gate)
    else:
        raise ValueError(f"unsupported hidden_act {cfg.hidden_act!r}")
    return h + qmatmul(act.to(x.dtype) * qmatmul(x, p["w_up"]), p["w_down"])


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
    def attn_fn(q, k, v):
        S = q.shape[1]
        k_row[:, length : length + S] = k.to(k_row.dtype)
        v_row[:, length : length + S] = v.to(v_row.dtype)
        return attention_step(q, k_row, v_row, positions, kv_positions)

    return attn_mlp_block(cfg, p, h, cos, sin, attn_fn)


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
    nlive: Optional[torch.Tensor] = None,  # [B] prefill traffic clamp
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
    return attn_mlp_block(cfg, p, h, cos, sin, paged_attn_fn(
        k_arena, v_arena, block_table, cols, positions, kv_positions, prefill, nlive,
        k_scale, v_scale, backend, valid,
    ))


def paged_attn_fn(
    k_arena, v_arena, block_table, cols, positions, kv_positions, prefill, nlive,
    k_scale, v_scale, backend, valid,
):
    """The attention of a paged layer, shared by the model families:
    scatter the fresh K/V (gated by ``valid``), then the chunked-prefill
    kernel for chunk-shaped queries or the decode kernel."""
    qkw = dict(k_scale=k_scale, v_scale=v_scale)

    def attn_fn(q, k, v):
        write_block_kv(k_arena, v_arena, block_table, cols, k, v, valid=valid, **qkw)
        if prefill:
            return paged_prefill(
                q, k_arena, v_arena, block_table, positions, kv_positions, nlive=nlive,
                backend=backend, **qkw,
            )
        return paged_attention(
            q, k_arena, v_arena, block_table, positions, kv_positions, backend=backend, **qkw
        )

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
        h = h * torch.tensor(cfg.embed_multiplier, dtype=h.dtype, device=h.device)
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
