"""Context (sequence) parallelism: a long prompt's prefill cut into chunks
over a context-parallel group (the port of
``llm_sharding_tpu/parallel/context.py``, whole).

The weights are whole on every device of the group; the token axis is cut
into ``N`` equal chunks, chunk ``i`` on ``devices[i]``, and each layer's
attention is ring attention (``ops/ring_attention.py``): exact causal
attention over the whole sequence, ``S/N``-sized score blocks only. The
JAX package runs the chunks as one ``shard_map`` program over a "seq"
mesh axis; the port's group is a device list of one process, and each
layer runs every chunk's q/k/v, then the ring, then every chunk's rest of
the block, through the family's split block (``models/llama.qkv`` /
``attn_proj`` / ``block_finish``, the same for GPT-2), so the arithmetic
is the block's own.

``context_prefill_cache`` also returns the decode state: the per-layer
K/V of every chunk assembled into one ``KVCache`` in the monolith's layout
(slot = sequence index, padded slots at the position sentinel, ``length =
S``), and ``context_generate`` hands it to
``runtime/generate.decode_from_cache``: the long prompt prefills
sequence-parallel, then decode goes on token-exact from the cache.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import hop
from ..models import gpt2, llama
from ..models.cache import POS_SENTINEL, KVCache
from ..models.config import ModelConfig
from ..ops.quant import act_dtype, base
from ..ops.ring_attention import ring_attention
from ..ops.rope import rope_cos_sin
from .pipeline import map_params, model_fns, visible_devices


def context_mesh(num_devices: int, devices=None) -> list:
    """The context-parallel group: the first ``num_devices`` of
    ``devices`` (default every visible GPU; a list may repeat a device)."""
    devs = visible_devices(None if devices is None else list(devices))
    if len(devs) < num_devices:
        raise ValueError(f"need {num_devices} devices, have {len(devs)}")
    return devs[:num_devices]


def _family(cfg: ModelConfig):
    if cfg.model_type == "llama":
        return llama
    if cfg.model_type == "gpt2":
        return gpt2
    raise NotImplementedError(f"context parallelism: {cfg.model_type!r} unsupported")


def _ctx_layer(cfg: ModelConfig, p: list, h: list, cos: list, sin: list, pos: list) -> tuple:
    """One decoder layer (llama or GPT-2) over every chunk with ring
    attention (``context.py:49``): ``p[i]`` is the layer's params on chunk
    ``i``'s device. Returns the chunks' hidden states and their K/V
    chunks, which the prefill keeps for the decode cache."""
    m = _family(cfg)
    qkv = [m.qkv(cfg, p[i], h[i], cos[i], sin[i]) for i in range(len(h))]
    outs = ring_attention([t[0] for t in qkv], [t[1] for t in qkv], [t[2] for t in qkv], pos, pos)
    h = [m.block_finish(cfg, p[i], h[i], m.attn_proj(cfg, p[i], o)) for i, o in enumerate(outs)]
    return h, [t[1] for t in qkv], [t[2] for t in qkv]


def _prep_tokens(devices: list, token_ids, prompt_len) -> tuple:
    """Shape and divisibility checks, and the sentinel positions (the
    single-device masking rule), ``context.py:149-170``."""
    token_ids = np.asarray(token_ids, np.int32)
    if token_ids.ndim == 1:
        token_ids = token_ids[None]
    B, S = token_ids.shape
    n = len(devices)
    if S % n != 0:
        raise ValueError(
            f"sequence length {S} not divisible by seq-axis size {n}; pad the "
            "prompt and pass prompt_len"
        )
    prompt_len = (np.full(B, S, np.int32) if prompt_len is None
                  else np.asarray(prompt_len, np.int32))
    idx = np.arange(S, dtype=np.int32)
    positions = np.where(idx[None, :] < prompt_len[:, None], idx[None, :], POS_SENTINEL)
    return token_ids, prompt_len, positions.astype(np.int32)


def _replicas(params: dict, devices: list) -> list:
    """The params on each chunk's device (one copy per distinct device)."""
    home = base(params["embed"]).device
    copies = {home: params}
    for d in devices:
        if d not in copies:
            copies[d] = map_params(lambda t, d=d: t.to(d), params)
    return [copies[d] for d in devices]


def _context_prefill(cfg: ModelConfig, devices: list, params: dict, token_ids: np.ndarray,
                     positions: np.ndarray, last_position: np.ndarray, full_logits: bool,
                     want_cache: bool = False, cache_dtype=None) -> tuple:
    """The program behind both entries (``context.py:65-146``): the
    logits (the last real token's, or every position's), and with
    ``want_cache`` each layer's K/V chunks."""
    fns = model_fns(cfg)
    N = len(devices)
    B, S = token_ids.shape
    s = S // N
    reps = _replicas(params, devices)
    ids = [torch.from_numpy(token_ids[:, i * s : (i + 1) * s]).to(d) for i, d in enumerate(devices)]
    pos = [torch.from_numpy(positions[:, i * s : (i + 1) * s]).to(d)
           for i, d in enumerate(devices)]
    h = [fns.embed(cfg, reps[i], ids[i], pos[i]) for i in range(N)]
    if cfg.model_type == "llama":
        cs = [rope_cos_sin(pos[i], cfg) for i in range(N)]
        cos, sin = [c for c, _ in cs], [t for _, t in cs]
    else:  # GPT-2: learned positions were added at embed
        cos = sin = [None] * N
    ks, vs = [], []
    for li in range(cfg.num_hidden_layers):
        h, k, v = _ctx_layer(cfg, [r["layers"][li] for r in reps], h, cos, sin, pos)
        if want_cache:
            ks.append([t.to(cache_dtype) for t in k])
            vs.append([t.to(cache_dtype) for t in v])
    dev = devices[0]
    if full_logits:
        logits = torch.cat([hop(fns.final_logits(cfg, reps[i], h[i]), dev) for i in range(N)],
                           dim=1)
    else:
        # each chunk selects its candidate for the last real token (zero
        # where that token lives elsewhere) and the sum over chunks
        # assembles it: [B, H], never [B, S, V]
        last = torch.from_numpy(np.asarray(last_position, np.int32))
        last_h = None
        for i in range(N):
            sel = (pos[i] == hop(last, devices[i])[:, None]).to(h[i].dtype)
            part = hop(torch.einsum("bs,bsh->bh", sel, h[i]), dev)
            last_h = part if last_h is None else last_h + part
        logits = fns.final_logits(cfg, reps[0], last_h)
    if not want_cache:
        return logits, None, None
    return logits, ks, vs


def context_prefill(cfg: ModelConfig, devices: list, params: dict, token_ids, prompt_len=None,
                    *, full_logits: bool = False) -> np.ndarray:
    """Sequence-parallel prefill over ``devices`` (``context.py:173``): the
    last real token's logits ``[B, V]``, or with ``full_logits`` every
    position's ``[B, S, V]``. ``S`` must divide by the group's size: pad
    the prompt and pass ``prompt_len`` (pads are masked by the sentinel,
    as on one device)."""
    devices = visible_devices(list(devices))
    token_ids, prompt_len, positions = _prep_tokens(devices, token_ids, prompt_len)
    logits, _, _ = _context_prefill(cfg, devices, params, token_ids, positions, prompt_len - 1,
                                    full_logits)
    return logits.float().cpu().numpy()


def context_prefill_cache(cfg: ModelConfig, devices: list, params: dict, token_ids,
                          prompt_len=None, *, cache_dtype=None) -> tuple:
    """Sequence-parallel prefill that also emits the decode state
    (``context.py:201``): ``(last_logits [B, V], KVCache)``, the cache in
    the monolith's layout on the first device (slot = sequence index,
    padded slots at the sentinel, ``length = S``), in ``cache_dtype``
    (default the weights' compute dtype)."""
    devices = visible_devices(list(devices))
    cache_dtype = cache_dtype or act_dtype(params["embed"])
    token_ids, prompt_len, positions = _prep_tokens(devices, token_ids, prompt_len)
    logits, ks, vs = _context_prefill(cfg, devices, params, token_ids, positions,
                                      prompt_len - 1, False, True, cache_dtype)
    dev = devices[0]

    def assemble(per_layer):  # [L] of N chunks [B, s, Nkv, D] -> [L, B, S, Nkv, D]
        return torch.stack([torch.cat([hop(c, dev) for c in chunks], dim=1)
                            for chunks in per_layer])

    cache = KVCache(k=assemble(ks), v=assemble(vs),
                    pos=torch.from_numpy(positions).to(dev), length=token_ids.shape[1])
    return logits, cache


def context_generate(
    cfg: ModelConfig,
    devices: list,
    params: dict,
    token_ids,
    max_new_tokens: int = 128,
    *,
    prompt_len=None,
    capacity: Optional[int] = None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    seed: int = 0,
    cache_dtype=None,
):
    """Long-context generation (``context.py:231``): ring-attention prefill
    over ``devices``, then ``decode_from_cache`` on the first device, with
    the draws of ``runtime/generate.generate`` (one for the first token,
    one per step), so the result equals ``generate``'s on the same weights
    and seed."""
    from ..runtime.generate import decode_from_cache

    logits, cache = context_prefill_cache(cfg, devices, params, token_ids, prompt_len,
                                          cache_dtype=cache_dtype)
    return decode_from_cache(
        cfg, params, token_ids, logits, cache, max_new_tokens, prompt_len=prompt_len,
        capacity=capacity, temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
    )
