"""The plain reference of a qwen2 model (Hugging Face ``modeling_qwen2``):
float32, TF32 off, no kernel, no cache, no batching.

It draws the weights again from the seed, layer by layer, with the
benchmark's ``weights`` module (the same bf16 values the program was
handed, widened to f32), and runs whole sequences through the model one
layer at a time, so that only one layer's weights are held at once.

The block: ``h + o(attn(rope(x Wq + bq), rope(x Wk + bk), x Wv + bv))``
with ``x = rmsnorm(h)``, grouped-query attention (query head ``j`` reads
KV head ``j // G``), causal, scaled by ``D ** -0.5``; then ``h +
W_down(silu(x W_gate) * x W_up)`` with ``x = rmsnorm(h)``; a final
rmsnorm and the head. RoPE is the ``rotate_half`` form with ``inv_freq =
theta ** (-2i / D)``.

``quant="fp8"`` is the control: every matrix product in float8 e4m3 on both
sides, as an fp8 GEMM takes them (the weights, the head's included, with one
scale per output column; the activations with one scale per row, that is per
token), the rest as above.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .. import weights

Q_BLOCK = 512  # queries per attention block
HEAD_BLOCK = 256  # positions per head product


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def _matrix(t: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    t = t.float()
    if quant is None:
        return t
    if quant != "fp8":
        raise ValueError(f"unknown control precision {quant!r}")
    return _fp8(t, 0)


def _mm(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """``x @ w``; under the control the activations in float8 too."""
    return (x if quant is None else _fp8(x, -1)) @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """``x [T, N, D]`` at positions ``0 .. T - 1``."""
    T, _, D = x.shape
    inv = 1.0 / (theta ** (np.arange(0, D, 2, dtype=np.float64) / D))
    ang = np.arange(T, dtype=np.float64)[:, None] * inv[None, :]
    cos = torch.from_numpy(np.cos(ang)).float().to(x.device)[:, None, :]
    sin = torch.from_numpy(np.sin(ang)).float().to(x.device)[:, None, :]
    x1, x2 = x[..., : D // 2], x[..., D // 2 :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal grouped-query attention: ``q [T, Nh, D]``, ``k, v [T, Nkv,
    D]`` -> ``[T, Nh * D]``, in blocks of queries."""
    T, Nh, D = q.shape
    Nkv = k.shape[1]
    G = Nh // Nkv
    out = torch.empty(T, Nh, D, dtype=q.dtype, device=q.device)
    for a in range(0, T, Q_BLOCK):
        b = min(a + Q_BLOCK, T)
        qg = q[a:b].reshape(b - a, Nkv, G, D)
        s = torch.einsum("bkgd,tkd->kgbt", qg, k[:b]) * D**-0.5
        qi = torch.arange(a, b, device=q.device)[:, None]
        ti = torch.arange(b, device=q.device)[None, :]
        s = s.masked_fill(ti > qi, float("-inf"))
        p = torch.softmax(s, dim=-1)
        out[a:b] = torch.einsum("kgbt,tkd->bkgd", p, v[:b]).reshape(b - a, Nh, D)
    return out.reshape(T, Nh * D)


def block(d, p: dict, h: torch.Tensor, quant: Optional[str] = None) -> torch.Tensor:
    T = h.shape[0]
    x = rms_norm(h, p["input_norm"], d.eps)
    q, k, v = _mm(x, p["wq"], quant), _mm(x, p["wk"], quant), _mm(x, p["wv"], quant)
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rope(q.view(T, d.Nh, d.D), d.theta)
    k = rope(k.view(T, d.Nkv, d.D), d.theta)
    h = h + _mm(attention(q, k, v.view(T, d.Nkv, d.D)), p["wo"], quant)
    x = rms_norm(h, p["post_norm"], d.eps)
    act = torch.nn.functional.silu(_mm(x, p["w_gate"], quant)) * _mm(x, p["w_up"], quant)
    return h + _mm(act, p["w_down"], quant)


def run(
    d,
    seed: int,
    seqs: list,  # int ids of each sequence
    positions: list,  # per sequence: the positions whose next-token logits are wanted
    consume: Callable,  # consume(seq_index, positions_block, logits_block [P, V] f32)
    device,
    quant: Optional[str] = None,
) -> None:
    """Next-token logits at ``positions`` of every sequence, handed to
    ``consume`` a block at a time."""
    _no_tf32()
    kinds = {name: kind for name, _, kind in weights.layer_leaves(d)}
    with torch.no_grad():
        table = weights.make_embed(d, seed, device)
        hs = [table[torch.as_tensor(np.asarray(s, np.int64), device=device)].float()
              for s in seqs]
        del table
        for i in range(d.L):
            raw = weights.make_layer(d, seed, i, device)
            p = {n: (_matrix(t, quant) if kinds[n] == "w" else t.float()) for n, t in raw.items()}
            del raw
            hs = [block(d, p, h, quant) for h in hs]
            del p
        norm = weights.make_final_norm(d, seed, device).float()
        head = _matrix(weights.make_embed(d, seed, device).T if d.tied
                       else weights.make_head(d, seed, device), quant)
        for j, (h, pos) in enumerate(zip(hs, positions)):
            pos = np.asarray(pos, np.int64)
            for a in range(0, len(pos), HEAD_BLOCK):
                blk = pos[a : a + HEAD_BLOCK]
                x = rms_norm(h[torch.as_tensor(blk, device=device)], norm, d.eps)
                consume(j, blk, _mm(x, head, quant))
