"""The one traffic generator: it reads a mix's parameters (a file under
``traffic/``) and yields the requests a run sends.

Every seed gets the same requests' sizes and, in an open loop, the same
gaps between arrivals, in the same order: sizes come in rounds, each round
holds the same quantiles of the mix's distributions in a fixed shuffled
order. What the seed draws is the prompts' tokens and each request's
sampling seed (and, in ``weights``, the model). So a window's work is the
same from seed to seed: at 0.8 of its knee the document-QA cell's
first-token tail moved 1.0-2.7 s between three seeds when the seed also
shuffled the order of arrivals.

A length distribution is ``{"dist": "lognormal", "median", "sigma", "min",
"max"}`` or ``{"dist": "uniform", "min", "max"}``. The mix's keys:

- ``loop``: ``"closed"`` (``clients`` each send their next request when the
  last one ends) or ``"open"`` (arrivals at ``rate`` requests a second,
  exponential gaps, from ``lead_seconds`` before the window opens);
- ``round``: the requests in one round of quantiles;
- ``prompt``, ``output``: the length distributions;
- ``sampling``: ``temperature``, ``top_k``, ``top_p`` of sampled requests,
  and ``greedy_per_round`` of each round sent greedy (all of them when
  ``temperature`` is 0);
- ``steady_start``: ``"residual"`` gives each closed-loop client's first
  request an output length from the residual-life distribution, as if it
  had been running for a while;
- ``cache_fill``: ``{"prompt", "wave"}``: before an open loop starts, waves
  of ``wave`` unique prompts of ``prompt`` tokens (one new token each) are
  served until the prefix cache first evicts, so the window opens on a full
  cache that evicts as it inserts (``Traffic.fill``).
"""

from __future__ import annotations

import dataclasses
from statistics import NormalDist
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class Spec:
    """One request as the generator makes it."""

    prompt: np.ndarray  # int32 ids
    max_new: int
    temperature: float
    top_k: int
    top_p: float
    seed: int  # the request's sampling seed
    gap: float = 0.0  # open loop: seconds after the previous arrival

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def quantiles(dist: dict, n: int) -> np.ndarray:
    """The ``n`` mid-quantiles ``(i + 0.5) / n`` of a length distribution,
    clipped and rounded to whole tokens."""
    q = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(x)) for x in q])
        x = dist["median"] * np.exp(dist["sigma"] * z)
    elif kind == "uniform":
        x = dist["min"] + q * (dist["max"] - dist["min"])
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return np.clip(np.rint(x), dist["min"], dist["max"]).astype(np.int64)


def exp_quantiles(mean: float, n: int) -> np.ndarray:
    """The ``n`` mid-quantiles of an exponential distribution of ``mean``."""
    q = (np.arange(n) + 0.5) / n
    return -mean * np.log1p(-q)


def residual_quantiles(dist: dict, n: int, grid: int = 4096) -> np.ndarray:
    """The ``n`` mid-quantiles of the residual life of a length drawn from
    ``dist``: the tokens still to come of a request caught at a uniform
    moment of its life. ``P(R <= x) = sum_j min(x, L_j) / sum_j L_j`` over
    the distribution's ``grid`` quantiles ``L_j``."""
    lengths = quantiles(dist, grid).astype(np.float64)
    total = lengths.sum()
    xs = np.arange(1, int(lengths.max()) + 1, dtype=np.float64)
    cdf = np.minimum(xs[:, None], lengths[None, :]).sum(axis=1) / total
    q = (np.arange(n) + 0.5) / n
    return xs[np.searchsorted(cdf, q)].astype(np.int64)


def _rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2**64, *salt]))


def token_high(cfg: dict) -> int:
    """Prompt ids are drawn below the first special id (the bos and eos
    ids sit at the top of the vocabulary)."""
    eos = cfg.get("eos_token_id")
    ids = [cfg.get("bos_token_id")] + (eos if isinstance(eos, list) else [eos])
    ids = [int(i) for i in ids if i is not None and int(i) > 0]
    return min(ids + [int(cfg["vocab_size"])])


class Traffic:
    """A mix's requests for one seed: ``first(n)`` the closed loop's first
    requests, one a client, and ``stream()`` every request after them (or
    every arrival of an open loop)."""

    def __init__(self, mix: dict, cfg: dict, seed: int):
        self.mix = mix
        self.seed = int(seed)
        self.high = token_high(cfg)
        self._tokens = _rng(seed, 1)
        s = mix.get("sampling", {})
        self.temperature = float(s.get("temperature", 0.0))
        self.top_k = int(s.get("top_k", 0))
        self.top_p = float(s.get("top_p", 1.0))
        self.round = int(mix["round"])
        self.greedy_per_round = (
            self.round if self.temperature <= 0 else int(s.get("greedy_per_round", 0))
        )

    def _spec(self, plen: int, max_new: int, greedy: bool, gap: float = 0.0) -> Spec:
        prompt = self._tokens.integers(0, self.high, size=int(plen), dtype=np.int64)
        seed = int(self._tokens.integers(0, 2**31 - 1))
        temp = 0.0 if greedy else self.temperature
        return Spec(prompt.astype(np.int32), int(max_new), temp, self.top_k, self.top_p, seed,
                    float(gap))

    def first(self, n: int) -> list:
        """The closed loop's first ``n`` requests (one a client): prompts of
        the mix, outputs from the residual life when ``steady_start`` says
        so."""
        if self.mix.get("steady_start") == "residual":
            outs = residual_quantiles(self.mix["output"], n)
        else:
            outs = quantiles(self.mix["output"], n)
        sizes = self._sizes(quantiles(self.mix["prompt"], n), outs)
        # by prompt length, so that requests of one admission bucket queue
        # together and co-admit: the clients fill in a few waves
        order = sorted(_rng(0, 2).permutation(n), key=lambda i: sizes[i][0])
        return [self._spec(*sizes[i]) for i in order]

    def fill(self) -> Iterator[Spec]:
        """The prefix cache's fill (``cache_fill``): unique greedy prompts of
        one length, one new token each, their ids drawn from the seed apart
        from the traffic's own."""
        plen = int(self.mix["cache_fill"]["prompt"])
        rng = _rng(self.seed, 5)
        while True:
            prompt = rng.integers(0, self.high, size=plen, dtype=np.int64).astype(np.int32)
            yield Spec(prompt, 1, 0.0, 0, 1.0, 0)

    def _sizes(self, plens: np.ndarray, outs: np.ndarray) -> list:
        """``(prompt, output, greedy)`` of each request of a round, paired
        the same way for every seed."""
        n = len(plens)
        fixed = _rng(0, 4)
        outs = fixed.permutation(outs)
        greedy = np.zeros(n, bool)
        greedy[fixed.permutation(n)[: round(self.greedy_per_round * n / self.round)]] = True
        return list(zip(plens, outs, greedy))

    def stream(self) -> Iterator[Spec]:
        """Rounds of the same requests' sizes (and an open loop's gaps), each
        round in its own fixed order."""
        sizes = self._sizes(quantiles(self.mix["prompt"], self.round),
                            quantiles(self.mix["output"], self.round))
        gap_q = np.zeros(self.round)
        if self.mix["loop"] == "open":
            gap_q = exp_quantiles(1.0 / float(self.mix["rate"]), self.round)
        k = 0
        while True:
            r = _rng(0, 3, k)
            for i, gap in zip(r.permutation(self.round), r.permutation(gap_q)):
                yield self._spec(*sizes[i], gap)
            k += 1


def reachable(mix: dict, buckets) -> list:
    """The admission buckets (of ``buckets``) that the mix's prompt lengths
    reach: a length goes to the smallest bucket that holds it."""
    lo, hi = int(mix["prompt"]["min"]), int(mix["prompt"]["max"])
    out, prev = [], 0
    for b in sorted(buckets):
        if b >= lo and prev < hi:
            out.append(b)
        prev = b
    return out
