"""The traffic generator: a seed repeats exactly, and every seed gets the
same sizes and gaps in the same order, with its own tokens."""

import numpy as np
import pytest

from servebench import gen, spec

from .conftest import TINY_CFG, TINY_MIXES

CELL_MIXES = ["chat", "docqa"]


def take(traffic, n):
    it = traffic.stream()
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("mix_name", CELL_MIXES)
def test_a_seed_repeats_exactly(mix_name):
    mix, cfg = spec.traffic(mix_name), TINY_CFG
    a, b = take(gen.Traffic(mix, cfg, 2**33 + 1), 70), take(gen.Traffic(mix, cfg, 2**33 + 1), 70)
    for x, y in zip(a, b):
        assert np.array_equal(x.prompt, y.prompt)
        for key in ("max_new", "temperature", "seed", "gap"):
            assert getattr(x, key) == getattr(y, key)


@pytest.mark.parametrize("mix_name", CELL_MIXES)
def test_seeds_share_the_schedule(mix_name):
    mix = spec.traffic(mix_name)
    n = int(mix["round"])
    runs = [take(gen.Traffic(mix, TINY_CFG, seed), 2 * n) for seed in (1, 2, 3**30)]
    sched = [[(len(s.prompt), s.max_new, s.greedy, s.gap) for s in specs] for specs in runs]
    assert sched[0] == sched[1] == sched[2]
    assert not np.array_equal(runs[0][0].prompt, runs[1][0].prompt)
    # each round holds the same sizes, each in its own order
    first, second = sched[0][:n], sched[0][n:]
    assert sorted(x[:3] for x in first) == sorted(x[:3] for x in second) and first != second
    assert sorted(x[3] for x in first) == sorted(x[3] for x in second)


def test_lengths_keep_to_the_mix():
    """The mixes hold the means their sources publish (chat: ShareGPT's
    161.31 / 337.99 tokens; docqa: LongBench's 5,229-token documents, cut
    to 8000) within their bounds."""
    mix = spec.traffic("docqa")
    q = gen.quantiles(mix["prompt"], 64)
    assert q.min() >= 1024 and q.max() <= 8000
    assert (q <= 2048).mean() == pytest.approx(0.11, abs=0.02)
    d = mix["prompt"]
    uncut = d["median"] * np.exp(d["sigma"] ** 2 / 2)
    assert uncut == pytest.approx(5229, rel=0.002)
    chat = spec.traffic("chat")
    assert gen.quantiles(chat["prompt"], 4096).mean() == pytest.approx(161.31, rel=0.005)
    assert gen.quantiles(chat["output"], 4096).mean() == pytest.approx(337.99, rel=0.005)
    specs = take(gen.Traffic(chat, TINY_CFG, 5), chat["round"])
    assert sum(s.greedy for s in specs) == chat["sampling"]["greedy_per_round"]
    assert all(s.prompt.max() < gen.token_high(TINY_CFG) for s in specs)


def test_closed_loop_starts_sorted_and_the_fill_is_its_own():
    """The closed loop's first requests come by prompt length (one bucket
    co-admits); the cache fill's prompts are unique, of one length, one new
    token each, and leave the traffic's own requests as they were."""
    chat = spec.traffic("chat")
    first = gen.Traffic(chat, TINY_CFG, 4).first(chat["clients"])
    assert [len(s.prompt) for s in first] == sorted(len(s.prompt) for s in first)
    mix = spec.traffic("docqa")
    t = gen.Traffic(mix, TINY_CFG, 2**33 + 3)
    fill = t.fill()
    got = [next(fill) for _ in range(3)]
    assert {len(s.prompt) for s in got} == {mix["cache_fill"]["prompt"]}
    assert all(s.max_new == 1 and s.greedy for s in got)
    assert not np.array_equal(got[0].prompt, got[1].prompt)
    plain = take(gen.Traffic(mix, TINY_CFG, 2**33 + 3), 3)
    assert all(np.array_equal(a.prompt, b.prompt) for a, b in zip(take(t, 3), plain))


def test_open_loop_gaps_hold_the_rate():
    mix = spec.traffic("docqa")
    gaps = [s.gap for s in take(gen.Traffic(mix, TINY_CFG, 3), 640)]
    assert np.mean(gaps) == pytest.approx(1.0 / mix["rate"], rel=0.05)


def test_residual_life_is_shorter_than_the_life():
    d = spec.traffic("chat")["output"]
    life, rest = gen.quantiles(d, 256), gen.residual_quantiles(d, 256)
    assert rest.min() >= 1 and rest.max() <= d["max"]
    assert rest.mean() < life.mean()
    first = gen.Traffic(TINY_MIXES["closed"], TINY_CFG, 9).first(4)
    assert len(first) == 4 and all(s.max_new >= 1 for s in first)


def test_reachable_buckets():
    buckets = (8, 16, 256, 512, 1024, 2048, 4096, 8192, 16384)
    assert gen.reachable(spec.traffic("chat"), buckets) == [8, 16, 256, 512, 1024]
    assert gen.reachable(spec.traffic("docqa"), buckets) == [1024, 2048, 4096, 8192]
