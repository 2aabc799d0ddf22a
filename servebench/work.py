"""Operations and bytes: per kernel and per model step, counted from the
requests a window served, never from launch shapes.

The arithmetic is ``chip_smoke.py``'s kernel bounds, frozen here: a bound
is the larger of operations over the peak rate and bytes over the HBM
rate; each input byte is counted once and each output byte once; an
attention kernel does 4 * Nh * D operations for each visible query-key
pair (QK^T and PV, a multiply and an add each); a query at position ``i``
sees ``i + 1`` keys. Padding is not counted.

Peaks: NVIDIA H100 SXM data sheet, dense bf16 989 TFLOP/s, HBM 3.35 TB/s.
"""

from __future__ import annotations

PEAK_FLOPS_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12
ELT = 2  # bytes of a bf16 element


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take for the work."""
    return max(flops / PEAK_FLOPS_BF16, nbytes / HBM_BYTES_PER_S)


def causal_pairs(q0: int, q1: int) -> int:
    """Visible pairs of the queries at positions ``q0 .. q1 - 1`` of one
    causal sequence: ``sum (i + 1)``."""
    return (q1 * (q1 + 1) - q0 * (q0 + 1)) // 2


def decode(d, ctx: int) -> tuple:
    """The paged decode kernel for one token attending ``ctx`` keys, all
    layers: ``(flops, bytes)``. Reads K and V of ``ctx`` keys and the query,
    writes the output."""
    flops = 4 * d.Nh * d.D * ctx * d.L
    nbytes = d.L * ELT * (2 * ctx * d.Nkv * d.D + 2 * d.Nh * d.D)
    return flops, nbytes


def flash(d, s: int) -> tuple:
    """The flash kernel for a one-shot admission of ``s`` real tokens, all
    layers: causal over the prompt; reads Q, K, V, writes the output."""
    flops = 4 * d.Nh * d.D * causal_pairs(0, s) * d.L
    nbytes = d.L * ELT * (2 * s * d.Nh * d.D + 2 * s * d.Nkv * d.D)
    return flops, nbytes


def paged_prefill(d, n_q: int, chunk: int) -> tuple:
    """The chunked prefill kernel for ``n_q`` real queries at positions ``0
    .. n_q - 1`` in chunks of ``chunk``, all layers: each chunk reads its
    queries and K and V up to its frontier, and writes its outputs."""
    flops = nbytes = 0
    for a in range(0, n_q, chunk):
        b = min(a + chunk, n_q)
        flops += 4 * d.Nh * d.D * causal_pairs(a, b) * d.L
        nbytes += d.L * ELT * (2 * (b - a) * d.Nh * d.D + 2 * b * d.Nkv * d.D)
    return flops, nbytes


def matmul_params(d) -> int:
    """Weights multiplied once per token, outside the embedding and the
    head: q, k, v, o and the gated MLP of every layer."""
    per_layer = d.H * (d.Nh + 2 * d.Nkv) * d.D + d.Nh * d.D * d.H + 3 * d.H * d.I
    return per_layer * d.L


def head_flops(d) -> int:
    return 2 * d.H * d.V


def token_flops(d, ctx: int) -> int:
    """Useful operations of one token through the model attending ``ctx``
    keys, without the head: the weights' products and the attention."""
    return 2 * matmul_params(d) + 4 * d.Nh * d.D * ctx * d.L


def prefill_flops(d, n_q: int) -> int:
    """Useful operations of ``n_q`` prompt tokens prefilled causally,
    without the head."""
    return 2 * matmul_params(d) * n_q + 4 * d.Nh * d.D * causal_pairs(0, n_q) * d.L
