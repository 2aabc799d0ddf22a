"""Seeded weights of a qwen2 (llama-block) model, drawn on the device in the
type they are served in.

Each layer's leaves are views of one buffer drawn by one ``randn`` call
from a generator seeded with ``(seed, layer)``; the embedding, the head and
the final norm take one call each. So any layer can be drawn again alone,
bit for bit: the reference does that, layer by layer, and never reads the
program's copy. The layout is ``[in, out]`` for every matrix.

Scales: normal / sqrt(fan_in) for every matrix (unit-variance outputs), a
standard normal embedding,
RMSNorm scales ``1 + 0.05 * normal``, q/k/v biases ``0.5 * normal`` (a
real Qwen2.5 carries large qkv biases; zero ones would leave them
untested). The head is ``HEAD_SCALE`` times larger: logits of standard
deviation 6, so that at temperature 0.7 the best token takes about 0.63 of
the mass on average and top-p 0.8 keeps about 3 tokens, as peaked as a
trained chat model's; at unit logits the top 20 of 152,064 lie within
about 0.05 of each other and the nucleus' edge is rounding's to decide.
"""

from __future__ import annotations

import dataclasses

import torch

NORM_SPREAD = 0.05
BIAS_SCALE = 0.5
HEAD_SCALE = 6.0


@dataclasses.dataclass(frozen=True)
class Dims:
    H: int
    I: int
    L: int
    Nh: int
    Nkv: int
    D: int
    V: int
    eps: float
    theta: float
    bias: bool
    tied: bool

    @classmethod
    def of(cls, cfg: dict) -> "Dims":
        H, Nh = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
        return cls(
            H=H, I=int(cfg["intermediate_size"]), L=int(cfg["num_hidden_layers"]), Nh=Nh,
            Nkv=int(cfg["num_key_value_heads"]), D=int(cfg.get("head_dim") or H // Nh),
            V=int(cfg["vocab_size"]), eps=float(cfg["rms_norm_eps"]),
            theta=float(cfg["rope_theta"]),
            bias=cfg.get("model_type") == "qwen2" or bool(cfg.get("attention_bias")),
            tied=bool(cfg.get("tie_word_embeddings", False)),
        )


def layer_leaves(d: Dims) -> list:
    """``(name, shape, kind)`` of one layer, in buffer order."""
    leaves = [
        ("input_norm", (d.H,), "norm"),
        ("wq", (d.H, d.Nh * d.D), "w"),
        ("wk", (d.H, d.Nkv * d.D), "w"),
        ("wv", (d.H, d.Nkv * d.D), "w"),
        ("wo", (d.Nh * d.D, d.H), "w"),
        ("post_norm", (d.H,), "norm"),
        ("w_gate", (d.H, d.I), "w"),
        ("w_up", (d.H, d.I), "w"),
        ("w_down", (d.I, d.H), "w"),
    ]
    if d.bias:
        leaves += [
            ("bq", (d.Nh * d.D,), "bias"),
            ("bk", (d.Nkv * d.D,), "bias"),
            ("bv", (d.Nkv * d.D,), "bias"),
        ]
    return leaves


def _generator(seed: int, part: int, device) -> torch.Generator:
    # one stream per part: (seed, part) mixed into 63 bits
    s = (int(seed) * 1_000_003 + 7919 * (part + 1)) % (2**63 - 1)
    return torch.Generator(device=device).manual_seed(s)


def _scaled(buf: torch.Tensor, shape, kind: str) -> torch.Tensor:
    t = buf.view(shape)
    if kind == "w":
        return t.mul_(shape[0] ** -0.5)
    if kind == "norm":
        return t.mul_(NORM_SPREAD).add_(1.0)
    return t.mul_(BIAS_SCALE)


def make_layer(d: Dims, seed: int, i: int, device, dtype=torch.bfloat16) -> dict:
    """Layer ``i``'s leaves: views of one buffer drawn in one call."""
    leaves = layer_leaves(d)
    sizes = [int(torch.Size(s).numel()) for _, s, _ in leaves]
    buf = torch.randn(sum(sizes), generator=_generator(seed, i, device), dtype=dtype,
                      device=device)
    out, off = {}, 0
    for (name, shape, kind), n in zip(leaves, sizes):
        out[name] = _scaled(buf[off : off + n], shape, kind)
        off += n
    return out


def make_embed(d: Dims, seed: int, device, dtype=torch.bfloat16) -> torch.Tensor:
    g = _generator(seed, d.L, device)
    return torch.randn(d.V * d.H, generator=g, dtype=dtype, device=device).view(d.V, d.H)


def make_head(d: Dims, seed: int, device, dtype=torch.bfloat16) -> torch.Tensor:
    g = _generator(seed, d.L + 1, device)
    return _scaled(torch.randn(d.H * d.V, generator=g, dtype=dtype, device=device),
                   (d.H, d.V), "w").mul_(HEAD_SCALE)


def make_final_norm(d: Dims, seed: int, device, dtype=torch.bfloat16) -> torch.Tensor:
    g = _generator(seed, d.L + 2, device)
    return _scaled(torch.randn(d.H, generator=g, dtype=dtype, device=device), (d.H,), "norm")


def make_params(d: Dims, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The whole model as the port's params dict (``models/llama.py``)."""
    params = {
        "embed": make_embed(d, seed, device, dtype),
        "layers": [make_layer(d, seed, i, device, dtype) for i in range(d.L)],
        "final_norm": make_final_norm(d, seed, device, dtype),
    }
    if not d.tied:
        params["lm_head"] = make_head(d, seed, device, dtype)
    return params
