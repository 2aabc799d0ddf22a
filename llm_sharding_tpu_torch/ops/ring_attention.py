"""Ring attention: exact causal attention over a sequence cut into chunks,
one per device of a context-parallel group (the port of
``llm_sharding_tpu/ops/ring_attention.py``, whole).

The JAX function runs under ``shard_map`` with the sequence sharded on a
mesh axis: each device holds its query chunk, and the KV chunks rotate
around the ring with ``lax.ppermute`` while a flash-style online softmax
accumulates. The port's context-parallel group is a list of devices of
one process, so the function takes every chunk at once and runs the same
schedule: at ring step ``s`` chunk ``i`` attends over the KV chunk that
started on chunk ``(i - s) mod N`` (the ``ppermute`` ring sends chunk
``j``'s KV to ``j + 1``), in f32, with JAX's ``-inf`` masking and its
``safe_m`` / ``corr`` guards. A query that sees no key at all (a padded
slot) comes out as zeros, JAX's rule (``l == 0`` → 0), not the attention
kernels' ``max(l, 1e-30)``.

It is plain PyTorch, as the JAX module has no Pallas form: a score block
is ``[S/N, S/N]`` per head, never ``[S, S]``.
"""

from __future__ import annotations

import torch

from ..device import hop


def ring_attention(
    q: list,  # N chunks [B, Sq, Nh, D] (RoPE'd), chunk i on its device
    k: list,  # N chunks [B, Skv, Nkv, D]
    v: list,
    q_positions: list,  # N chunks [B, Sq] absolute positions (sentinel = pad)
    kv_positions: list,  # N chunks [B, Skv]
    scale: float | None = None,
) -> list:
    """Exact attention of each query chunk over the whole (ring-gathered)
    key/value sequence; returns the N output chunks ``[B, Sq, Nh, D]`` in
    the queries' dtype, each on its chunk's device."""
    N = len(q)
    B, Sq, Nh, D = q[0].shape
    Nkv = k[0].shape[2]
    G = Nh // Nkv
    if scale is None:
        scale = D ** -0.5
    out = []
    for i in range(N):
        dev = q[i].device
        qg = q[i].reshape(B, Sq, Nkv, G, D).float()
        qpos = q_positions[i]
        acc = torch.zeros((B, Sq, Nkv, G, D), dtype=torch.float32, device=dev)
        m = torch.full((B, Sq, Nkv, G), float("-inf"), dtype=torch.float32, device=dev)
        l = torch.zeros((B, Sq, Nkv, G), dtype=torch.float32, device=dev)
        for s in range(N):
            j = (i - s) % N
            kj, vj = hop(k[j], dev).float(), hop(v[j], dev).float()
            kvpos = hop(kv_positions[j], dev)
            scores = torch.einsum("bskgd,btkd->bskgt", qg, kj) * scale
            mask = (kvpos[:, None, :] <= qpos[:, :, None])[:, :, None, None, :]
            scores = torch.where(mask, scores, float("-inf"))
            m_blk = scores.amax(dim=-1)
            m_new = torch.maximum(m, m_blk)
            # rows with nothing valid anywhere yet keep m = -inf; keep exp finite
            safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(torch.where(torch.isfinite(scores), scores - safe_m[..., None],
                                      float("-inf")))
            corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bskgt,btkd->bskgd", p, vj)
            m = m_new
        o = torch.where(l[..., None] > 0, acc / l.clamp_min(1e-30)[..., None], 0.0)
        out.append(o.reshape(B, Sq, Nh, D).to(q[i].dtype))
    return out
