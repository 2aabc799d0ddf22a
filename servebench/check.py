"""What decides ``correct``: served tokens held against the plain reference.

After the window, a sample of the finished requests, drawn from the seed
with the longest greedy one in it, is run through the reference once each
(prompt plus served tokens). The numbers compared:

- ``greedy_gap`` (logits): the widest gap by which a greedy token's
  reference logit lies below the reference's best at its position, and
  ``greedy_gap_mean``, that gap's mean over every greedy position;
- ``topk_gap`` (logits): the widest gap by which a sampled token's reference
  logit lies below the reference's k-th best (top-k, the request's own k),
  and ``topk_gap_mean``;
- ``topp_excess`` (probability): the most by which the reference's mass
  before a sampled token, among the top-k at the request's temperature,
  passes the request's top-p (the nucleus keeps a token while that mass is
  under top-p); ``1 - top_p`` for a token outside the top-k; and
  ``topp_excess_mean``, its mean over every sampled position. A sampler
  that ignores top-p or the temperature draws past the reference's nucleus.

A cell's ``limits/<cell>.json`` names the numbers it compares: those whose
sound readings and control readings lie apart (``PERF.md`` gives both).
The top-p boundary is read as mass, not as a logit gap: a token at the
nucleus' edge that rounding moves in or out may sit far below the last
token the reference keeps, while its mass moves only with the rounding.

The control (``control.py``) is the reference with its matrices in float8:
at the same positions of the same sequences it reads the gap of the token it
puts first (greedy), of the lowest token of its own top-k, and the excess of
the token of its own nucleus that the reference finds furthest out.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .reference import qwen2

LIMITS_DIR = Path(__file__).resolve().parent / "limits"


@dataclasses.dataclass
class Item:
    """One compared request: its prompt, served tokens and sampling."""

    prompt: np.ndarray
    tokens: list
    temperature: float
    top_k: int
    top_p: float

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def pick(finished: list, check: dict, seed: int) -> list:
    """The compared requests, drawn from ``finished`` (``Item``s) by the seed:
    the longest greedy one, ``greedy_random`` more greedy ones and
    ``sampled_random`` sampled ones."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) % 2**64, 9]))
    greedy = sorted((it for it in finished if it.greedy), key=lambda it: -len(it.tokens))
    sampled = [it for it in finished if not it.greedy]
    out = greedy[:1]
    for pool, key in ((greedy[1:], "greedy_random"), (sampled, "sampled_random")):
        n = min(int(check.get(key, 0)), len(pool))
        out += [pool[i] for i in sorted(rng.choice(len(pool), n, replace=False))] if n else []
    return out


def _ranked(logits: torch.Tensor, it: Item) -> tuple:
    """The reference's top-k at ``[P, V]`` logits: ids ``[P, k]`` (best
    first), the k-th logit ``[P]``, and the mass before each rank ``[P, k]``
    among them at the request's temperature."""
    k = it.top_k if 0 < it.top_k < logits.shape[-1] else logits.shape[-1]
    vals, ids = torch.topk(logits.float(), k, dim=-1)
    probs = torch.softmax(vals / it.temperature, dim=-1)
    return ids, vals[:, -1], torch.cumsum(probs, dim=-1) - probs


def _excess(ids: torch.Tensor, before: torch.Tensor, tok: torch.Tensor,
            top_p: float) -> torch.Tensor:
    """``[P]`` the top-p excess of token ``tok [P]`` (see the module)."""
    hit = ids == tok[:, None]
    mass = torch.where(hit, before, torch.zeros_like(before)).sum(dim=-1)
    return torch.where(hit.any(dim=-1), mass - top_p,
                       torch.full_like(mass, 1.0 - top_p)).clamp(min=0)


def _sequences(items: list) -> tuple:
    seqs, positions = [], []
    for it in items:
        n, plen = len(it.tokens), len(it.prompt)
        seqs.append(np.concatenate([it.prompt, np.asarray(it.tokens[:-1], np.int32)]))
        positions.append(np.arange(plen - 1, plen + n - 1))
    return seqs, positions


def choices(d, seed: int, items: list, device, quant: str) -> list:
    """What a lower-precision reference chooses at each compared position:
    per item ``[P]`` token ids (greedy), or ``[P, k, 2]``: the ids of its
    top-k, and the same ids with -1 past its nucleus (sampled)."""
    seqs, positions = _sequences(items)
    out = [[] for _ in items]

    def consume(j, blk, logits):
        it = items[j]
        if it.greedy:
            out[j].append(logits.argmax(dim=-1).cpu())
            return
        ids, _, before = _ranked(logits, it)
        out[j].append(torch.stack([ids, torch.where(before < it.top_p, ids, -1)], dim=-1).cpu())

    qwen2.run(d, seed, seqs, positions, consume, device, quant=quant)
    return [torch.cat(parts) for parts in out]


def gaps(d, seed: int, items: list, device, control: Optional[list] = None) -> dict:
    """The numbers of ``items``' served tokens against the f32 reference
    (with ``control``, ``choices``: the control's at the same positions): the
    widest gap of each kind, and the greedy and top-k gaps' means over their
    positions (``_mean``). A cell's limits file says which it compares."""
    seqs, positions = _sequences(items)
    worst: dict = {}
    sums: dict = {}
    offsets = [0] * len(items)

    def note(key, values: torch.Tensor):
        worst[key] = max(worst.get(key, float("-inf")), float(values.max()))
        total, n = sums.get(key, (0.0, 0))
        sums[key] = (total + float(values.sum()), n + values.numel())

    def consume(j, blk, logits):
        it = items[j]
        a = offsets[j]
        offsets[j] += len(blk)
        rows = torch.arange(len(blk), device=logits.device)
        if control is None:
            tok = torch.as_tensor(it.tokens[a : a + len(blk)], device=logits.device)
        else:
            tok = control[j][a : a + len(blk)].to(logits.device)
        if it.greedy:
            note("greedy_gap", logits.amax(dim=-1) - logits[rows, tok])
            return
        ids, kth, before = _ranked(logits, it)
        if control is None:
            note("topk_gap", (kth - logits[rows, tok]).clamp(min=0))
            note("topp_excess", _excess(ids, before, tok, it.top_p))
            return
        # the control: its top-k's lowest, and its nucleus' furthest out
        topk, nucleus = tok[..., 0], tok[..., 1]
        note("topk_gap", (kth - logits.gather(-1, topk).amin(dim=-1)).clamp(min=0))
        ex = torch.stack([_excess(ids, before, nucleus[:, c].clamp(min=0), it.top_p)
                          .masked_fill(nucleus[:, c] < 0, 0.0)
                          for c in range(nucleus.shape[1])], dim=-1)
        note("topp_excess", ex.amax(dim=-1))

    qwen2.run(d, seed, seqs, positions, consume, device)
    out = dict(worst)
    for key in ("greedy_gap", "topk_gap", "topp_excess"):
        if key in sums:
            out[f"{key}_mean"] = sums[key][0] / sums[key][1]
    return out


def load_limits(cell: str) -> dict:
    return json.loads((LIMITS_DIR / f"{cell}.json").read_text())["limits"]


def verdict(numbers: dict, limits: dict, failed: int) -> tuple:
    """``(correct, lines)``: every number at or under its limit, and no
    request failed."""
    lines, ok = [], failed == 0
    other = {k: v for k, v in numbers.items() if k not in limits}
    if other:
        lines.append("read, not compared: " + ", ".join(f"{k} {v!r}" for k, v in other.items()))
    lines.append(f"failed_requests {failed} limit 0")
    for name, limit in limits.items():
        value = numbers.get(name)
        if value is None:  # nothing of that kind finished: not shown correct
            ok = False
            lines.append(f"{name} none limit {limit!r}")
            continue
        ok &= value <= limit
        lines.append(f"{name} {value!r} limit {limit!r}")
    return ok, lines
