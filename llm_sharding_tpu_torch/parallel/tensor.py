"""Tensor parallelism: megatron shards of a layer over a tensor group (the
port of ``llm_sharding_tpu/parallel/tensor.py``, all but its
``jax.sharding`` plumbing).

The JAX package annotates every weight with a ``PartitionSpec`` over the
"tensor" mesh axis and lets GSPMD (or its explicit ``shard_map`` pipeline)
split the matmuls and insert the ``psum``s. Here a split rule names what
each leaf of a layer does over the group, and ``shard_params_tp`` cuts one
parameter tree per shard, each on its own device:

- ``COL``: column-parallel weight ``[in, out]``, split on ``out``
  (wq / wk / wv / w_gate / w_up; GPT-2's w_qkv / w_fc);
- ``ROW``: row-parallel weight, split on ``in`` (wo / w_down; w_proj /
  w_out): its product is a partial the block sums (``models/stack.
  tp_reduce``), its bias added once, after the sum;
- ``COL_B``: a column-parallel bias, split with its columns;
- ``REP``: replicated (norms, the row-parallel biases, the vocab tables:
  the head is sharded over pipeline stages, ``parallel/head.py``, never
  over the tensor group).

A quantized weight's codes split like the raw weight; its per-column
scale follows the columns of a column-parallel weight and is whole
beside a row-parallel one (``quant_leaf_spec``). Every leaf of a shard is a
contiguous tensor of its own: the attention kernels refuse strided
operands (``ops/kernels.check_operand``).

GPT-2's fused qkv is column-PERMUTED first (``qkv_perm_indices``), so
shard ``j``'s contiguous slice is its ``[q_j | k_j | v_j]``, as in the
JAX package's explicit path.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..models.cache import KVCache
from ..models.config import ModelConfig
from ..models.stack import HeadShards, Shards
from ..ops.quant import QTensor
from .pipeline import map_params

TENSOR_AXIS = "tensor"

COL, ROW, COL_B, REP = "col", "row", "col_bias", "rep"


def llama_tp_specs() -> dict:
    """Split rules of llama-family parameters (``tensor.py:41-69``)."""
    return {
        "layers": {
            "input_norm": REP, "wq": COL, "wk": COL, "wv": COL, "wo": ROW,
            "post_norm": REP, "w_gate": COL, "w_up": COL, "w_down": ROW,
            # optional biases (qwen2): column biases shard with their
            # columns; the row-parallel output bias is added once, post-sum
            "bq": COL_B, "bk": COL_B, "bv": COL_B, "bo": REP,
        },
        "embed": REP,
        "final_norm": REP,
        "lm_head": COL,
    }


def gpt2_tp_specs() -> dict:
    """Split rules of GPT-2 parameters (``tensor.py:72-101``); the fused
    qkv must be permuted first (``permute_gpt2_tp_layers``)."""
    return {
        "layers": {
            "ln1_w": REP, "ln1_b": REP, "w_qkv": COL, "b_qkv": COL_B,
            "w_proj": ROW, "b_proj": REP, "ln2_w": REP, "ln2_b": REP,
            "w_fc": COL, "b_fc": COL_B, "w_out": ROW, "b_out": REP,
        },
        "embed": REP,
        "pos_embed": REP,
        "final_norm": REP,
        "final_norm_bias": REP,
        "lm_head": COL,
    }


def tp_specs(cfg: ModelConfig) -> dict:
    if cfg.model_type == "llama":
        return llama_tp_specs()
    if cfg.model_type == "gpt2":
        return gpt2_tp_specs()
    raise NotImplementedError(f"TP specs: {cfg.model_type!r} unsupported")


def quant_leaf_spec(spec: str, leaf):
    """Per-component rules of a maybe-quantized leaf (``tensor.py:104``):
    a ``QTensor``'s codes split like the raw weight and its ``[out]``
    scale drops the contracted axis, so it splits with a column-parallel
    weight's columns and stays whole beside a row-parallel one. A raw
    leaf keeps ``spec``."""
    if not isinstance(leaf, QTensor):
        return spec
    return type(leaf)(q=spec, scale=COL_B if spec == COL else REP)


def _split(t: torch.Tensor, rule: str, tp: int, j: int) -> torch.Tensor:
    """Shard ``j`` of ``tp`` of ``t`` under ``rule``, contiguous."""
    if rule == REP:
        return t
    axis = -2 if rule == ROW else -1
    n = t.shape[axis]
    w = n // tp
    return t.narrow(axis, j * w, w).contiguous()


def split_leaf(leaf, rule: str, tp: int, j: int):
    """Shard ``j`` of a maybe-quantized leaf."""
    if isinstance(leaf, QTensor):
        sub = quant_leaf_spec(rule, leaf)
        return type(leaf)(q=_split(leaf.q, sub.q, tp, j), scale=_split(leaf.scale, sub.scale, tp, j))
    return _split(leaf, rule, tp, j)


def qkv_perm_indices(h3: int, tp: int) -> np.ndarray:
    """Column permutation of a fused-qkv last axis ``[q | k | v]`` →
    ``[q_0 k_0 v_0 | q_1 k_1 v_1 | ...]`` (``tensor.py:135``): a
    contiguous ``1/tp`` slice is then a head-aligned (q, k, v) triple."""
    H = h3 // 3
    Hl = H // tp
    idx = []
    for t in range(tp):
        for blk in range(3):
            start = blk * H + t * Hl
            idx.extend(range(start, start + Hl))
    return np.asarray(idx, np.int32)


def _take_cols(w, idx: torch.Tensor):
    """Column-permute a maybe-quantized weight (the per-column scale
    permutes with its columns)."""
    if isinstance(w, QTensor):
        return type(w)(q=w.q.index_select(-1, idx.to(w.q.device)),
                       scale=w.scale.index_select(-1, idx.to(w.scale.device)))
    return w.index_select(-1, idx.to(w.device))


def permute_gpt2_tp_layers(layers: dict, tp: int) -> dict:
    """One GPT-2 layer with its fused qkv weight and bias permuted for a
    tensor group of ``tp`` (``tensor.py:164``); other leaves pass through."""
    idx = torch.from_numpy(qkv_perm_indices(int(layers["b_qkv"].shape[-1]), tp)).long()
    out = dict(layers)
    out["w_qkv"] = _take_cols(layers["w_qkv"], idx)
    out["b_qkv"] = _take_cols(layers["b_qkv"], idx)
    return out


# Memo of the permutation, keyed by the IDENTITY of the w_qkv leaf (the
# entry holds a strong reference to it, so an id cannot be reused by a new
# tensor); bounded (``tensor.py:177-197``).
_PERMUTE_CACHE: dict = {}


def permute_gpt2_tp_layers_cached(layers: dict, tp: int) -> dict:
    key = (tp, id(layers["w_qkv"]))
    hit = _PERMUTE_CACHE.get(key)
    if hit is not None and hit[0] is layers["w_qkv"]:
        out = dict(layers)
        out.update(hit[1])
        return out
    permuted = permute_gpt2_tp_layers(layers, tp)
    if len(_PERMUTE_CACHE) >= 4:
        _PERMUTE_CACHE.clear()
    _PERMUTE_CACHE[key] = (
        layers["w_qkv"], {"w_qkv": permuted["w_qkv"], "b_qkv": permuted["b_qkv"]},
    )
    return permuted


def validate_tp(cfg: ModelConfig, tp: int) -> None:
    for name, val in (
        ("num_attention_heads", cfg.num_attention_heads),
        ("num_key_value_heads", cfg.num_key_value_heads),
        ("intermediate_size", cfg.intermediate_size),
    ):
        if val % tp != 0:
            raise ValueError(f"{name}={val} not divisible by tensor size {tp}")


def shard_layer_tp(cfg: ModelConfig, layer: dict, devices: list) -> Shards:
    """One layer's parameters as ``Shards`` over ``devices`` (the tensor
    group): shard ``j``'s megatron slice of each leaf on ``devices[j]``.
    GPT-2's fused qkv is permuted first (memoized on the leaf)."""
    tp = len(devices)
    rules = tp_specs(cfg)["layers"]
    if cfg.model_type == "gpt2":
        layer = permute_gpt2_tp_layers_cached(layer, tp)
    return Shards(
        [{k: map_params(lambda t, d=d: t.to(d), split_leaf(v, rules[k], tp, j))
          for k, v in layer.items()}
         for j, d in enumerate(devices)],
        devices,
    )


def shard_params_tp(cfg: ModelConfig, params: Any, devices: list) -> list:
    """One parameter tree per shard of the tensor group ``devices``
    (``tensor.py:209``), shard ``j``'s on ``devices[j]``: the megatron
    slices of the layers (a list of per-layer dicts, GPT-2's qkv permuted)
    and of an untied ``lm_head``, the replicated leaves whole. Quantized
    leaves split per component (``quant_leaf_spec``)."""
    tp = len(devices)
    validate_tp(cfg, tp)
    specs = tp_specs(cfg)
    per_layer = [shard_layer_tp(cfg, layer, devices) for layer in params["layers"]]
    out = []
    for j, d in enumerate(devices):
        tree = {k: map_params(lambda t, d=d: t.to(d), split_leaf(v, specs[k], tp, j))
                for k, v in params.items() if k != "layers"}
        tree["layers"] = [shards[j] for shards in per_layer]
        out.append(tree)
    return out


def shard_cache_tp(cache: KVCache, devices: list) -> KVCache:
    """A dense cache split over heads (``[L, B, C, Nkv, D]`` → ``Nkv / tp``
    per shard, ``tensor.py:242``): ``k`` / ``v`` become ``HeadShards``;
    ``pos`` and the offset stay on the first device."""
    def heads(t):
        return HeadShards([p.contiguous().to(d) for p, d in
                           zip(t.chunk(len(devices), dim=-2), devices)], devices)

    return KVCache(k=heads(cache.k), v=heads(cache.v), pos=cache.pos.to(devices[0]),
                   length=cache.length)
