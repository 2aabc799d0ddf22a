"""Weight-matmul helpers, raw-weight path (counterpart of
``llm_sharding_tpu/ops/quant.py:123-167``), and the KV-arena quantizer
(``:268-331``).

Weights keep the JAX package's ``[in, out]`` layout, so ``x @ w`` is the
projection and the tied head contracts against the ``[V, H]`` embedding
table. Logits are cast to fp32 AFTER the dot, as in the JAX package. The
int8/int4 ``QTensor`` path comes with the quantized-store slice; the shard
store refuses such stores (``utils/shard_store.py``).
"""

from __future__ import annotations

import torch


def qmatmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a raw ``[in, out]`` weight."""
    return x @ w


def embed_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Embedding lookup ``table[ids]`` on a raw ``[V, H]`` table."""
    return table[ids.long()]


def head_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Untied head ``x @ w`` (``w [H, V]``), fp32 after the dot."""
    return (x @ w).float()


def tied_logits(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Tied head ``x @ table.T`` (``table [V, H]``), fp32 after the dot."""
    return (x @ table.t()).float()


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
