"""Shard store: save, convert and role-conditional loading, byte-compatible
with ``llm_sharding_tpu/utils/shard_store.py``.

Layout (one numpy ``.npz`` per unit, ``shard_store.py:8-17``)::

    <dir>/config.json        ModelConfig JSON
    <dir>/tokenizer*         tokenizer files copied from the HF checkpoint
    <dir>/embedding.npz      {"embed": [V, H]} (+ "pos_embed" [P, H], gpt2)
    <dir>/block_{i}.npz      one decoder layer's weights
    <dir>/final_norm.npz     {"final_norm": [H]} (+ "final_norm_bias", gpt2)
    <dir>/lm_head.npz        {"lm_head": [H, V]}, absent when tied

Tags (``shard_store.py:56-101``): npz cannot hold bfloat16, so a bf16
array is stored as its ``uint16`` view plus a ``<name>__dtype`` tag; the
port decodes it with ``Tensor.view(torch.bfloat16)``, no ``ml_dtypes``
needed. An int8 ``QTensor`` is stored as ``<name>__q`` (int8 codes) plus
``<name>__scale``; an ``Int4QTensor`` as ``<name>__q4`` (two values per
byte along the last axis, low nibble = even index, an odd axis padded)
plus ``<name>__q4dim`` (the unpacked size) and ``<name>__scale``. On load
the codes stay int8 (int4 unpacks to int8, in numpy, so the bytes are the
JAX package's exactly) and only the scales and raw tensors take the load
dtype.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from ..device import NotPorted, resolve_device
from ..models.config import ModelConfig
from ..ops.quant import Int4QTensor, QTensor, quantize_layer_params, quantize_tensor
from .convert import (
    _getter,
    as_tensor,
    gpt2_layer_arrays,
    gpt2_prefix,
    llama_layer_arrays,
    tensor_from_numpy,  # noqa: F401 - the port's numpy → tensor entry point
)

_DTYPE_TAG = "__dtype"
_Q_SUFFIX = "__q"
_Q4_SUFFIX = "__q4"
_Q4_DIM_TAG = "__q4dim"
_SCALE_SUFFIX = "__scale"
_TAGGED = {"bfloat16": (np.uint16, torch.bfloat16)}
# weights are not copied with the tokenizer files (``shard_store.py:50``)
_WEIGHT_SUFFIXES = (".bin", ".safetensors", ".pth", ".pt", ".gguf")


def _pack_int4(a: np.ndarray) -> np.ndarray:
    """int8 values in [-8, 7] → packed bytes, pairs along the last axis
    (low nibble = even index, high nibble = odd index)."""
    a = np.asarray(a, np.int8)
    if a.shape[-1] % 2:
        a = np.concatenate([a, np.zeros((*a.shape[:-1], 1), np.int8)], axis=-1)
    lo = a[..., 0::2] & 0xF
    hi = a[..., 1::2] & 0xF
    return (lo | (hi << 4)).astype(np.int8)


def _unpack_int4(p: np.ndarray, last_dim: int) -> np.ndarray:
    """Packed bytes → int8 values (arithmetic shifts restore the sign)."""
    p = np.asarray(p, np.int8)
    lo = (p << 4) >> 4
    hi = p >> 4
    out = np.stack([lo, hi], axis=-1).reshape(*p.shape[:-1], -1)
    return out[..., :last_dim]


def _encode(out: dict, name: str, t: torch.Tensor) -> None:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        out[name] = t.view(torch.int16).numpy().view(np.uint16)
        out[name + _DTYPE_TAG] = np.asarray("bfloat16")
    else:
        out[name] = t.numpy()


def _save_npz(path: str, arrays: dict) -> None:
    out: dict = {}
    for k, v in arrays.items():
        if isinstance(v, Int4QTensor):
            q = v.q.detach().cpu().numpy()
            out[k + _Q4_SUFFIX] = _pack_int4(q)
            out[k + _Q4_DIM_TAG] = np.asarray(q.shape[-1])
            _encode(out, k + _SCALE_SUFFIX, v.scale)
        elif isinstance(v, QTensor):
            _encode(out, k + _Q_SUFFIX, v.q)
            _encode(out, k + _SCALE_SUFFIX, v.scale)
        else:
            _encode(out, k, v)
    np.savez(path, **out)


def _load_npz(path: str, dtype: Optional[torch.dtype], device) -> dict:
    """One unit's tensors on ``device``: raw tensors and quantized scales
    cast to ``dtype`` (``None`` keeps the stored dtype), codes int8."""

    def decode(z, k) -> torch.Tensor:
        a = np.ascontiguousarray(z[k])
        tag = k + _DTYPE_TAG
        if tag not in z.files:
            return torch.from_numpy(a)
        name = str(z[tag])
        if name not in _TAGGED:
            raise NotPorted(f"{path}: stored dtype {name!r} is not supported")
        np_view, t_dtype = _TAGGED[name]
        return torch.from_numpy(a.view(np_view)).view(t_dtype)

    def cast(t: torch.Tensor) -> torch.Tensor:
        return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)

    def scale(z, base: str) -> torch.Tensor:
        if base + _SCALE_SUFFIX not in z.files:
            raise ValueError(f"{path}: quantized weight {base!r} has no {_SCALE_SUFFIX} entry")
        return cast(decode(z, base + _SCALE_SUFFIX))

    res: dict = {}
    with np.load(path) as z:
        for k in z.files:
            if k.endswith((_DTYPE_TAG, _SCALE_SUFFIX, _Q4_DIM_TAG)):
                continue
            if k.endswith(_Q4_SUFFIX):
                base = k[: -len(_Q4_SUFFIX)]
                q = _unpack_int4(z[k], int(z[base + _Q4_DIM_TAG]))
                res[base] = Int4QTensor(
                    q=torch.from_numpy(np.ascontiguousarray(q)).to(device), scale=scale(z, base)
                )
            elif k.endswith(_Q_SUFFIX):
                base = k[: -len(_Q_SUFFIX)]
                res[base] = QTensor(q=decode(z, k).to(device), scale=scale(z, base))
            else:
                res[k] = cast(decode(z, k))
    return res


def _write_config(cfg: ModelConfig, out_dir: str, tokenizer_dir: Optional[str]) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    if tokenizer_dir:
        copy_tokenizer_files(tokenizer_dir, out_dir)


def save_shards(
    cfg: ModelConfig, params: dict, out_dir: str, tokenizer_dir: Optional[str] = None
) -> None:
    """Write the port's params (``layers`` a list of per-layer dicts; any
    leaf may be a ``QTensor``) as a store either package loads."""
    _write_config(cfg, out_dir, tokenizer_dir)
    emb = {k: params[k] for k in ("embed", "pos_embed") if k in params}
    _save_npz(os.path.join(out_dir, "embedding.npz"), emb)
    for i in range(cfg.num_hidden_layers):
        _save_npz(os.path.join(out_dir, f"block_{i}.npz"), params["layers"][i])
    fn = {k: params[k] for k in ("final_norm", "final_norm_bias") if k in params}
    _save_npz(os.path.join(out_dir, "final_norm.npz"), fn)
    if "lm_head" in params:  # a tied model reuses embedding.npz
        _save_npz(os.path.join(out_dir, "lm_head.npz"), {"lm_head": params["lm_head"]})


def save_shards_streaming(
    cfg: ModelConfig,
    src,
    out_dir: str,
    dtype: torch.dtype = torch.bfloat16,
    tokenizer_dir: Optional[str] = None,
    quantize: bool = False,
    quantize_head: bool = False,
    quant_bits: int = 8,
) -> None:
    """Write a store straight from an HF name → tensor source, one unit at
    a time, so no more than one layer is ever held. ``quantize`` stores
    the layers' matmul weights as ``quant_bits`` codes (8 or 4) with
    per-column scales in ``dtype``; ``quantize_head`` also the vocab
    tables (embed per row, an untied lm_head per column)."""

    def maybe_q(t: torch.Tensor, axis: int):
        return quantize_tensor(t, contract_axis=axis, bits=quant_bits) if quantize_head else t

    get = _getter(src)
    _write_config(cfg, out_dir, tokenizer_dir)
    layer_fn = llama_layer_arrays if cfg.model_type == "llama" else gpt2_layer_arrays
    for i in range(cfg.num_hidden_layers):
        block = layer_fn(cfg, get, i, dtype)
        if quantize:
            block = quantize_layer_params(block, bits=quant_bits)
        _save_npz(os.path.join(out_dir, f"block_{i}.npz"), block)

    if cfg.model_type == "llama":
        embed = as_tensor(get("model.embed_tokens.weight"), dtype)
        _save_npz(os.path.join(out_dir, "embedding.npz"), {"embed": maybe_q(embed, -1)})
        _save_npz(
            os.path.join(out_dir, "final_norm.npz"),
            {"final_norm": as_tensor(get("model.norm.weight"), dtype)},
        )
        if not cfg.tie_word_embeddings:
            head = as_tensor(get("lm_head.weight"), dtype).t().contiguous()
            _save_npz(os.path.join(out_dir, "lm_head.npz"), {"lm_head": maybe_q(head, -2)})
    else:  # gpt2: the head is tied to wte
        pre = gpt2_prefix(get)
        _save_npz(os.path.join(out_dir, "embedding.npz"), {
            "embed": maybe_q(as_tensor(get(pre + "wte.weight"), dtype), -1),
            "pos_embed": as_tensor(get(pre + "wpe.weight"), dtype),
        })
        _save_npz(os.path.join(out_dir, "final_norm.npz"), {
            "final_norm": as_tensor(get(pre + "ln_f.weight"), dtype),
            "final_norm_bias": as_tensor(get(pre + "ln_f.bias"), dtype),
        })


def copy_tokenizer_files(src_dir: str, out_dir: str) -> None:
    """Copy the checkpoint's config and tokenizer files, not its weights."""
    for name in os.listdir(src_dir):
        p = os.path.join(src_dir, name)
        if not os.path.isfile(p):
            continue
        if name.endswith(_WEIGHT_SUFFIXES) or name.endswith(".index.json") or name == "config.json":
            continue
        shutil.copy2(p, os.path.join(out_dir, name))


def load_config(shards_dir: str) -> ModelConfig:
    with open(os.path.join(shards_dir, "config.json")) as f:
        return ModelConfig.from_json(f.read())


def load_tokenizer(shards_dir: str):
    """The HF tokenizer copied into a store, or None when the store holds
    no tokenizer files or ``transformers`` cannot load them (it is an
    optional extra, absent on the GPU machine)."""
    if not any(f.startswith("tokenizer") for f in os.listdir(shards_dir)):
        return None
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(shards_dir)
    except Exception:  # noqa: BLE001 - the tokenizer is an optional extra
        return None


def _zeros_like(v):
    if isinstance(v, QTensor):
        return type(v)(q=torch.zeros_like(v.q), scale=torch.zeros_like(v.scale))
    return torch.zeros_like(v)


def load_stage(
    shards_dir: str,
    start: int,
    end: int,
    dtype: Optional[torch.dtype] = torch.bfloat16,
    user_facing: Optional[bool] = None,
    pad_to: Optional[int] = None,
    device=None,
) -> dict[str, Any]:
    """One pipeline stage's params for layers ``[start, end)`` on
    ``device`` (default the GPU; ``shard_store.py:308-365``): the
    embedding iff ``user_facing`` (default ``start == 0``), the final norm
    and head iff ``end`` is the last layer (a tied last stage that is not
    user-facing loads the embedding table for its head). ``pad_to`` pads
    the layer list with all-zero layers, and ``layer_mask`` (bool
    ``[pad_to]``) marks the real ones."""
    dev = resolve_device(device)
    cfg = load_config(shards_dir)
    L = cfg.num_hidden_layers
    if not (0 <= start < end <= L):
        raise ValueError(f"invalid layer range [{start}, {end}) for {L}-layer model")
    if user_facing is None:
        user_facing = start == 0
    layers = [
        _load_npz(os.path.join(shards_dir, f"block_{i}.npz"), dtype, dev)
        for i in range(start, end)
    ]
    n = end - start
    pad_to = pad_to or n
    if pad_to < n:
        raise ValueError(f"pad_to={pad_to} < stage size {n}")
    if pad_to > n:
        pad = {k: _zeros_like(v) for k, v in layers[0].items()}
        layers += [pad] * (pad_to - n)
    stage: dict[str, Any] = {
        "layers": layers,
        "layer_mask": torch.arange(pad_to, device=dev) < n,
        "start": start,
        "end": end,
    }
    if user_facing:
        stage.update(_load_npz(os.path.join(shards_dir, "embedding.npz"), dtype, dev))
    if end == L:
        stage.update(_load_npz(os.path.join(shards_dir, "final_norm.npz"), dtype, dev))
        head = os.path.join(shards_dir, "lm_head.npz")
        if os.path.exists(head):
            stage.update(_load_npz(head, dtype, dev))
        elif "embed" not in stage:
            stage["embed"] = _load_npz(os.path.join(shards_dir, "embedding.npz"), dtype, dev)["embed"]
    return stage


def load_full(
    shards_dir: str, dtype: Optional[torch.dtype] = torch.bfloat16, device=None
) -> tuple[ModelConfig, dict]:
    """The whole model on ``device`` (default the GPU), raw tensors and
    scales cast to ``dtype`` (``None`` keeps the stored dtypes)."""
    cfg = load_config(shards_dir)
    stage = load_stage(shards_dir, 0, cfg.num_hidden_layers, dtype, user_facing=True,
                       device=device)
    return cfg, {k: v for k, v in stage.items() if k not in ("layer_mask", "start", "end")}


def convert_hf_checkpoint(
    model_dir: str,
    out_dir: str,
    dtype: torch.dtype = torch.bfloat16,
    quantize: bool = False,
    quantize_head: bool = False,
    quant_bits: int = 8,
) -> ModelConfig:
    """Convert an HF checkpoint directory (``config.json`` plus
    ``*.safetensors``, or torch ``*.bin``) into a store, streaming one
    tensor at a time from safetensors (``shard_store.py:376-445``)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = ModelConfig.from_hf_config(json.load(f))
    st_files = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
    handles: list = []
    if st_files:
        from safetensors import safe_open

        index: dict = {}
        for fn in st_files:
            handle = safe_open(os.path.join(model_dir, fn), framework="pt")
            handles.append(handle)
            for name in handle.keys():
                index[name] = handle

        def get(name: str) -> torch.Tensor:
            if name not in index:
                raise KeyError(name)
            return index[name].get_tensor(name)

    else:
        bins = sorted(f for f in os.listdir(model_dir) if f.endswith(".bin"))
        if not bins:
            raise FileNotFoundError(f"no safetensors/bin weights in {model_dir}")
        sd: dict = {}
        for fn in bins:
            sd.update(torch.load(os.path.join(model_dir, fn), map_location="cpu",
                                 weights_only=True))
        get = sd.__getitem__
    try:
        save_shards_streaming(
            cfg, get, out_dir, dtype, tokenizer_dir=model_dir, quantize=quantize,
            quantize_head=quantize_head, quant_bits=quant_bits,
        )
    finally:
        for h in handles:
            close = getattr(h, "close", None)
            if close is not None:
                close()
    return cfg
