"""Shard store: save and load, byte-compatible with
``llm_sharding_tpu/utils/shard_store.py``.

Layout (one numpy ``.npz`` per unit, ``shard_store.py:8-17``)::

    <dir>/config.json        ModelConfig JSON
    <dir>/embedding.npz      {"embed": [V, H]}
    <dir>/block_{i}.npz      one decoder layer's weights
    <dir>/final_norm.npz     {"final_norm": [H]}
    <dir>/lm_head.npz        {"lm_head": [H, V]}, absent when tied

npz cannot hold bfloat16, so a bf16 array is stored as its ``uint16`` view
plus a ``<name>__dtype`` tag naming the type (``shard_store.py:56-72,
95-101, 127-132``). The port decodes it with
``torch.from_numpy(a).view(torch.bfloat16)``: no ``ml_dtypes`` needed.
Quantized stores (``__q`` int8 / ``__q4`` int4 tags) raise ``NotPorted``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..device import NotPorted, resolve_device
from ..models.config import ModelConfig

_DTYPE_TAG = "__dtype"
_QUANT_TAGS = ("__q", "__q4", "__q4dim", "__scale")
_TAGGED = {"bfloat16": (np.uint16, torch.bfloat16)}


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """numpy → CPU tensor, including ml_dtypes bfloat16 arrays (numpy kind
    'V', as ``np.asarray`` of a JAX bf16 array gives)."""
    if a.dtype.kind == "V":
        if a.dtype.name != "bfloat16":
            raise NotPorted(f"numpy dtype {a.dtype.name} has no torch counterpart here")
        return torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


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
        _encode(out, k, v)
    np.savez(path, **out)


def _load_npz(path: str, dtype: Optional[torch.dtype], device) -> dict:
    res = {}
    with np.load(path) as z:
        for k in z.files:
            if k.endswith(_DTYPE_TAG):
                continue
            if any(k.endswith(tag) for tag in _QUANT_TAGS):
                raise NotPorted(
                    f"{path}: quantized weights ({k!r}) load in the quantized-store "
                    "slice of the port (ROADMAP.md §A slice 7 and later); convert "
                    "the store without quantization"
                )
            a = z[k]
            tag = k + _DTYPE_TAG
            if tag in z.files:
                name = str(z[tag])
                if name not in _TAGGED:
                    raise NotPorted(f"{path}: stored dtype {name!r} is not supported")
                np_view, t_dtype = _TAGGED[name]
                t = torch.from_numpy(np.ascontiguousarray(a).view(np_view)).view(t_dtype)
            else:
                t = torch.from_numpy(np.ascontiguousarray(a))
            res[k] = t.to(device=device, dtype=dtype if dtype is not None else t.dtype)
    return res


def save_shards(cfg: ModelConfig, params: dict, out_dir: str) -> None:
    """Write the port's params (``models/llama`` layout: ``layers`` is a
    list of per-layer dicts) as a store either package loads."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    _save_npz(os.path.join(out_dir, "embedding.npz"), {"embed": params["embed"]})
    for i, layer in enumerate(params["layers"]):
        _save_npz(os.path.join(out_dir, f"block_{i}.npz"), layer)
    _save_npz(os.path.join(out_dir, "final_norm.npz"), {"final_norm": params["final_norm"]})
    if "lm_head" in params:
        _save_npz(os.path.join(out_dir, "lm_head.npz"), {"lm_head": params["lm_head"]})


def load_config(shards_dir: str) -> ModelConfig:
    with open(os.path.join(shards_dir, "config.json")) as f:
        return ModelConfig.from_json(f.read())


def load_full(
    shards_dir: str, dtype: Optional[torch.dtype] = torch.bfloat16, device=None
) -> tuple[ModelConfig, dict]:
    """Load the whole model onto ``device`` (default the GPU), cast to
    ``dtype`` (``None`` keeps the stored dtypes). Returns ``(cfg, params)``
    in the ``models/llama`` layout."""
    dev = resolve_device(device)
    cfg = load_config(shards_dir)
    params = _load_npz(os.path.join(shards_dir, "embedding.npz"), dtype, dev)
    params["layers"] = [
        _load_npz(os.path.join(shards_dir, f"block_{i}.npz"), dtype, dev)
        for i in range(cfg.num_hidden_layers)
    ]
    params.update(_load_npz(os.path.join(shards_dir, "final_norm.npz"), dtype, dev))
    head = os.path.join(shards_dir, "lm_head.npz")
    if os.path.exists(head):
        params.update(_load_npz(head, dtype, dev))
    return cfg, params
