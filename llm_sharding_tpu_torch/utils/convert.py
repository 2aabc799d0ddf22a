"""HF checkpoint → the port's parameters (counterpart of
``llm_sharding_tpu/utils/convert.py:30-153``).

Maps HF weight names to the layout of ``models/llama.py`` /
``models/gpt2.py``: weights ``[in, out]``, ``layers`` a list of per-layer
dicts. Inputs are name → tensor mappings (numpy arrays or torch tensors)
or a getter that raises ``KeyError`` for a missing name, so a checkpoint
can be streamed one tensor at a time (``shard_store.convert_hf_checkpoint``).
Every cast rounds to nearest even, on the CPU, as the JAX package's does.
"""

from __future__ import annotations

from typing import Callable, Mapping, Union

import numpy as np
import torch

from ..device import NotPorted, resolve_device
from ..models.config import ModelConfig

TensorGetter = Callable[[str], Union[np.ndarray, torch.Tensor]]


def _getter(src) -> TensorGetter:
    if callable(src):
        return src
    return lambda name: src[name]


def _has(get: TensorGetter, name: str) -> bool:
    try:
        get(name)
        return True
    except KeyError:
        return False


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """numpy → CPU tensor, including ml_dtypes bfloat16 arrays (numpy kind
    'V', as ``np.asarray`` of a JAX bf16 array gives)."""
    if a.dtype.kind == "V":
        if a.dtype.name != "bfloat16":
            raise NotPorted(f"numpy dtype {a.dtype.name} has no torch counterpart here")
        return torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def as_tensor(a, dtype: torch.dtype) -> torch.Tensor:
    """A contiguous CPU tensor of ``dtype`` from a numpy array or a tensor."""
    if not isinstance(a, torch.Tensor):
        a = tensor_from_numpy(np.asarray(a))
    return a.to(dtype).contiguous()


def llama_layer_arrays(cfg: ModelConfig, get: TensorGetter, i: int, dtype) -> dict:
    """One decoder layer's params. torch ``Linear`` stores ``[out, in]``,
    so each projection is transposed. q/k/v/o biases are probed, not
    assumed (qwen2 biases q/k/v only); ``mlp_bias`` is refused rather
    than dropped."""
    if cfg.mlp_bias:
        raise ValueError(
            "mlp_bias checkpoints are not wired through yet; refusing to "
            "silently drop bias tensors"
        )
    pre = f"model.layers.{i}."

    def lin(name):
        return as_tensor(get(pre + name + ".weight"), dtype).t().contiguous()

    p = {
        "input_norm": as_tensor(get(pre + "input_layernorm.weight"), dtype),
        "wq": lin("self_attn.q_proj"),
        "wk": lin("self_attn.k_proj"),
        "wv": lin("self_attn.v_proj"),
        "wo": lin("self_attn.o_proj"),
        "post_norm": as_tensor(get(pre + "post_attention_layernorm.weight"), dtype),
        "w_gate": lin("mlp.gate_proj"),
        "w_up": lin("mlp.up_proj"),
        "w_down": lin("mlp.down_proj"),
    }
    if cfg.attention_bias:
        for key, name in (
            ("bq", "self_attn.q_proj"),
            ("bk", "self_attn.k_proj"),
            ("bv", "self_attn.v_proj"),
            ("bo", "self_attn.o_proj"),
        ):
            if _has(get, pre + name + ".bias"):
                p[key] = as_tensor(get(pre + name + ".bias"), dtype)
    return p


def gpt2_layer_arrays(cfg: ModelConfig, get: TensorGetter, i: int, dtype) -> dict:
    """One GPT-2 block. HF ``Conv1D`` stores ``[in, out]`` already: no
    transpose. Names carry a ``transformer.`` prefix or none."""
    pre = f"transformer.h.{i}." if _has(get, f"transformer.h.{i}.ln_1.weight") else f"h.{i}."

    def t(name):
        return as_tensor(get(pre + name), dtype)

    return {
        "ln1_w": t("ln_1.weight"),
        "ln1_b": t("ln_1.bias"),
        "w_qkv": t("attn.c_attn.weight"),
        "b_qkv": t("attn.c_attn.bias"),
        "w_proj": t("attn.c_proj.weight"),
        "b_proj": t("attn.c_proj.bias"),
        "ln2_w": t("ln_2.weight"),
        "ln2_b": t("ln_2.bias"),
        "w_fc": t("mlp.c_fc.weight"),
        "b_fc": t("mlp.c_fc.bias"),
        "w_out": t("mlp.c_proj.weight"),
        "b_out": t("mlp.c_proj.bias"),
    }


def gpt2_prefix(get: TensorGetter) -> str:
    return "transformer." if _has(get, "transformer.wte.weight") else ""


def params_from_hf(
    cfg: ModelConfig,
    src: Union[Mapping, TensorGetter],
    dtype: torch.dtype = torch.bfloat16,
    device=None,
) -> dict:
    """The full model's params from an HF name → tensor source, on
    ``device`` (default the GPU). A tied model gets no ``lm_head``: its
    head contracts against the embedding table."""
    dev = resolve_device(device)
    get = _getter(src)
    if cfg.model_type == "llama":
        params = {
            "embed": as_tensor(get("model.embed_tokens.weight"), dtype),
            "layers": [llama_layer_arrays(cfg, get, i, dtype) for i in range(cfg.num_hidden_layers)],
            "final_norm": as_tensor(get("model.norm.weight"), dtype),
        }
        if not cfg.tie_word_embeddings:
            params["lm_head"] = as_tensor(get("lm_head.weight"), dtype).t().contiguous()
    elif cfg.model_type == "gpt2":
        pre = gpt2_prefix(get)
        params = {
            "embed": as_tensor(get(pre + "wte.weight"), dtype),
            "pos_embed": as_tensor(get(pre + "wpe.weight"), dtype),
            "layers": [gpt2_layer_arrays(cfg, get, i, dtype) for i in range(cfg.num_hidden_layers)],
            "final_norm": as_tensor(get(pre + "ln_f.weight"), dtype),
            "final_norm_bias": as_tensor(get(pre + "ln_f.bias"), dtype),
        }
    else:
        raise ValueError(f"unsupported model_type: {cfg.model_type!r}")
    return {
        k: [{n: t.to(dev) for n, t in p.items()} for p in v] if k == "layers" else v.to(dev)
        for k, v in params.items()
    }


def params_from_numpy(cfg: ModelConfig, tree: dict, dtype=None, device=None) -> dict:
    """The JAX package's params pytree (numpy leaves, layers stacked
    ``[L, ...]``, quantized weights as its ``QTensor`` / ``Int4QTensor``
    nodes) → the port's params on ``device``, quantized weights as the
    port's ``QTensor`` / ``Int4QTensor`` with their int8 codes as they
    are. ``dtype`` casts the raw leaves and the scales (``None`` keeps
    them)."""
    from ..ops.quant import Int4QTensor, QTensor

    dev = resolve_device(device)

    def conv(a):
        t = tensor_from_numpy(np.asarray(a))
        return t.to(device=dev, dtype=dtype if dtype is not None else t.dtype)

    def leaf(a):
        if getattr(a, "_fields", None) != ("q", "scale"):
            return conv(a)
        cls = Int4QTensor if type(a).__name__ == "Int4QTensor" else QTensor
        return cls(q=tensor_from_numpy(np.asarray(a.q)).to(dev), scale=conv(a.scale))

    def row(v, i):
        return type(v)(q=v.q[i].clone(), scale=v.scale[i].clone()) if isinstance(v, QTensor) else v[i].clone()

    stacked = {k: leaf(v) for k, v in tree["layers"].items()}
    params = {k: leaf(v) for k, v in tree.items() if k != "layers"}
    params["layers"] = [{k: row(v, i) for k, v in stacked.items()} for i in range(cfg.num_hidden_layers)]
    return params
