"""Weight quantization and the weight-matmul helpers (counterpart of
``llm_sharding_tpu/ops/quant.py:34-250``), and the KV-arena quantizer
(``:268-331``).

Weights keep the JAX package's ``[in, out]`` layout, so ``x @ w`` is the
projection and the tied head contracts against the ``[V, H]`` embedding
table. Logits are cast to fp32 AFTER the dot, as in the JAX package.

Quantized weights: symmetric absmax per output channel. For a weight
``[in, out]`` the scale is ``absmax(w, axis=in) / qmax`` per ``out``
column, kept in the weight's own dtype; ``QTensor`` holds the int8 codes
and that scale. ``Int4QTensor`` holds values in [-7, 7] with ``absmax /
7`` scales, int8-resident on the device as in the JAX package; only the
shard store packs two values per byte (``utils/shard_store.py``). A
matmul against a ``QTensor`` multiplies ``x`` by the codes cast to
``x``'s dtype and scales the product per column, in the activation dtype
(``qmatmul``); the vocab heads scale after the fp32 cast
(``head_logits``, ``tied_logits``). The cast materializes a copy of the
weight in the activation dtype on every call: no kernel fuses it yet.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch


class QTensor(NamedTuple):
    """An int8-quantized weight: ``q`` int8 codes of the weight's shape,
    ``scale`` the per-output-channel scale in the weight's dtype (per
    ROW ``[V]`` for an embedding table quantized along ``H``)."""

    q: torch.Tensor
    scale: torch.Tensor


class Int4QTensor(QTensor):
    """An int4-quantized weight (values in [-7, 7], ``absmax / 7`` scales),
    int8-resident like ``QTensor``; nibble-packed only on disk."""


WeightLike = Union[torch.Tensor, QTensor]

# Layer-weight keys quantized by default: the matmul weights. Norm gains and
# biases stay in the model dtype (tiny, precision-critical).
LLAMA_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
GPT2_QUANT_KEYS = ("w_qkv", "w_out", "w_fc", "w_proj")


def quantize_tensor(w: torch.Tensor, contract_axis: int = -2, bits: int = 8) -> QTensor:
    """Symmetric per-output-channel quantization; ``contract_axis`` is the
    axis a matmul contracts over (the scale is constant along it, so it
    factors out of the dot). The arithmetic is the JAX function's: f32
    absmax, ``scale = (absmax / qmax)`` cast to ``w``'s dtype, codes
    ``round(w / max(absmax, 1e-12) * qmax)`` in f32, divide then multiply,
    half to even."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    qmax = 127.0 if bits == 8 else 7.0
    absmax = w.float().abs().amax(dim=contract_axis)
    scale = (absmax / qmax).to(w.dtype)
    denom = absmax.clamp_min(1e-12).unsqueeze(contract_axis)
    q = torch.round(w.float() / denom * qmax).to(torch.int8)
    return (QTensor if bits == 8 else Int4QTensor)(q=q, scale=scale)


def dequantize(t: QTensor, contract_axis: int = -2) -> torch.Tensor:
    scale = t.scale.unsqueeze(contract_axis)
    return t.q.to(scale.dtype) * scale


def base(w: WeightLike) -> torch.Tensor:
    """The storage tensor of a maybe-quantized weight (shape, device)."""
    return w.q if isinstance(w, QTensor) else w


def out_dim(w: WeightLike) -> int:
    """Output (last-axis) size of a maybe-quantized weight."""
    return base(w).shape[-1]


def act_dtype(w: WeightLike) -> torch.dtype:
    """The compute dtype a maybe-quantized weight was made in: a
    ``QTensor``'s scale carries it, a raw tensor is it
    (``llm_sharding_tpu/runtime/server.py:1204-1213``)."""
    return w.scale.dtype if isinstance(w, QTensor) else w.dtype


def qmatmul(x: torch.Tensor, w: WeightLike) -> torch.Tensor:
    """``x @ w`` for a raw ``[in, out]`` weight or a ``QTensor``, whose
    per-column scale multiplies the product in ``x``'s dtype."""
    if isinstance(w, QTensor):
        return (x @ w.q.to(x.dtype)) * w.scale.to(x.dtype)
    return x @ w


def embed_rows(table: WeightLike, ids: torch.Tensor) -> torch.Tensor:
    """Embedding lookup ``table[ids]`` on a raw ``[V, H]`` table or a
    row-quantized ``QTensor``, of which only the gathered rows are
    dequantized (into the scale's dtype)."""
    ids = ids.long()
    if isinstance(table, QTensor):
        return table.q[ids].to(table.scale.dtype) * table.scale[ids][..., None]
    return table[ids]


def head_logits(x: torch.Tensor, w: WeightLike) -> torch.Tensor:
    """Untied head ``x @ w`` (``w [H, V]``), fp32 after the dot; a
    ``QTensor``'s per-column scale is applied AFTER the fp32 cast."""
    if isinstance(w, QTensor):
        return (x @ w.q.to(x.dtype)).float() * w.scale.float()
    return (x @ w).float()


def tied_logits(x: torch.Tensor, table: WeightLike) -> torch.Tensor:
    """Tied head ``x @ table.T`` (``table [V, H]``), fp32 after the dot; a
    row-quantized table's per-row scale is applied AFTER the fp32 cast."""
    if isinstance(table, QTensor):
        return (x @ table.q.to(x.dtype).t()).float() * table.scale.float()
    return (x @ table.t()).float()


def quantize_layer_params(layer: dict, keys=None, bits: int = 8) -> dict:
    """Quantize one layer's matmul weights (``keys``, default both
    families'); other leaves, and weights already quantized, pass through."""
    if keys is None:
        keys = LLAMA_QUANT_KEYS + GPT2_QUANT_KEYS
    return {
        k: quantize_tensor(v, bits=bits) if k in keys and not isinstance(v, QTensor) else v
        for k, v in layer.items()
    }


def quantize_params(
    params: dict, keys=None, quantize_head: bool = False, bits: int = 8
) -> dict:
    """Quantize every layer's matmul weights. ``quantize_head`` also
    quantizes the vocab tables: ``embed [V, H]`` per ROW (valid for both
    the lookup and the tied head), an untied ``lm_head [H, V]`` per
    column. Norms, biases and ``pos_embed`` stay in the model dtype."""
    out = dict(params)
    out["layers"] = [quantize_layer_params(p, keys, bits=bits) for p in params["layers"]]
    if quantize_head:
        for k, ax in (("embed", -1), ("lm_head", -2)):
            if k in out and not isinstance(out[k], QTensor):
                out[k] = quantize_tensor(out[k], contract_axis=ax, bits=bits)
    return out


def is_quantized(layer: dict) -> bool:
    return any(isinstance(v, QTensor) for v in layer.values())


# ---------------------------------------------------------------- KV arena
# Quantized paged KV (counterpart of ``ops/quant.py:268-331``): the arena
# holds 1-byte int8 or fp8-e4m3 codes and a per-(block, KV head) f32 scale,
# ``scale = running absmax / qmax``. The decode and chunked-prefill kernels
# stream the codes and dequantize in shared memory; the plain versions
# dequantize at the gather. The arithmetic below is the JAX package's
# exactly, so both packages write the same bytes.

#: ``kv_dtype`` vocabulary. "bf16" means "store in the engine's own cache
#: dtype" (no quantization; an f32 engine keeps an f32 arena).
KV_DTYPES = ("bf16", "int8", "fp8")

_KV_QMAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0}  # e4m3fn max normal


def kv_storage_dtype(name: str, compute_dtype: torch.dtype = torch.bfloat16) -> torch.dtype:
    """Resolve a ``kv_dtype`` name to the arena storage dtype."""
    if name == "bf16":
        return compute_dtype
    if name == "int8":
        return torch.int8
    if name == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(f"kv dtype must be one of {KV_DTYPES}, got {name!r}")


def is_kv_quantized(dtype: torch.dtype) -> bool:
    """True for the 1-byte KV storage dtypes, which carry scale arenas."""
    return dtype in _KV_QMAX


def kv_qmax(dtype: torch.dtype) -> float:
    if dtype not in _KV_QMAX:
        raise ValueError(f"{dtype} is not a quantized KV dtype")
    return _KV_QMAX[dtype]


def fp8_kv_supported(device: torch.device) -> bool:
    """Whether ``kv_dtype="fp8"`` can serve on ``device``: on the CPU, the
    plain versions' float8_e4m3fn casts; on CUDA, a card the sm_90a
    kernels run on (compute capability 9.0 or newer)."""
    if not hasattr(torch, "float8_e4m3fn"):
        return False
    if device.type == "cuda":
        return torch.cuda.get_device_capability(device) >= (9, 0)
    return device.type == "cpu"


def kv_quantize(x: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Codes of ``x`` against a broadcastable scale; a zero scale (a
    virgin block) quantizes zeros to zeros through the safe denominator.
    int8 rounds half to even, as ``jnp.round`` does."""
    y = x.float() / torch.clamp_min(scale, 1e-12)
    qmax = kv_qmax(dtype)
    if dtype == torch.int8:
        return torch.clamp(torch.round(y), -qmax, qmax).to(torch.int8)
    return torch.clamp(y, -qmax, qmax).to(dtype)


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Inverse of ``kv_quantize``: an f32 multiply, then the cast to the
    compute dtype (the same two roundings the kernels do per element)."""
    return (q.float() * scale).to(out_dtype)
