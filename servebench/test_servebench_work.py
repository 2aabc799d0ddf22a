"""work.py against counts made by hand at small shapes."""

import pytest

from servebench import work
from servebench.weights import Dims

D = Dims(H=8, I=16, L=2, Nh=4, Nkv=2, D=2, V=32, eps=1e-6, theta=1e6, bias=True, tied=False)


def test_causal_pairs():
    assert work.causal_pairs(0, 1) == 1
    assert work.causal_pairs(0, 4) == 1 + 2 + 3 + 4
    assert work.causal_pairs(2, 4) == 3 + 4
    assert work.causal_pairs(0, 3) + work.causal_pairs(3, 7) == work.causal_pairs(0, 7)


def test_decode_counts_each_key_once():
    flops, nbytes = work.decode(D, 5)
    assert flops == 4 * 4 * 2 * 5 * 2  # 4 Nh D per key, two layers
    # K and V of 5 keys (2 KV heads x 2) and q + out (4 heads x 2), bf16, two layers
    assert nbytes == 2 * 2 * (2 * 5 * 2 * 2 + 2 * 4 * 2)


def test_flash_is_causal_over_real_tokens():
    flops, nbytes = work.flash(D, 3)
    assert flops == 4 * 4 * 2 * 6 * 2
    assert nbytes == 2 * 2 * (2 * 3 * 4 * 2 + 2 * 3 * 2 * 2)


def test_chunks_read_kv_to_their_frontier():
    flops, nbytes = work.paged_prefill(D, 5, 2)  # chunks [0,2) [2,4) [4,5)
    assert flops == 4 * 4 * 2 * work.causal_pairs(0, 5) * 2
    q_out = 2 * 5 * 4 * 2
    kv = 2 * (2 + 4 + 5) * 2 * 2
    assert nbytes == 2 * 2 * (q_out + kv)
    one = work.paged_prefill(D, 5, 8)
    assert one[0] == flops and one[1] < nbytes


def test_model_counts():
    per_layer = 8 * (4 + 2 * 2) * 2 + 4 * 2 * 8 + 3 * 8 * 16
    assert work.matmul_params(D) == 2 * per_layer
    assert work.head_flops(D) == 2 * 8 * 32
    assert work.token_flops(D, 3) == 2 * 2 * per_layer + 4 * 4 * 2 * 3 * 2
    assert work.prefill_flops(D, 3) == 2 * 2 * per_layer * 3 + 4 * 4 * 2 * 6 * 2


def test_bound_takes_the_larger_side():
    assert work.bound_s(989e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert work.bound_s(989e12, 6.7e12) == pytest.approx(2.0)


def test_published_sizes():
    from servebench import spec
    import json
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    bench = spec.load_benchmark(root)
    d14 = Dims.of(spec.config(bench, root, "qwen25_14b"))
    d7 = Dims.of(spec.config(bench, root, "qwen25_7b"))
    embed = lambda d: 2 * d.V * d.H  # noqa: E731 (embedding and head, untied)
    biases = lambda d: d.L * (d.Nh + 2 * d.Nkv) * d.D  # noqa: E731
    norms = lambda d: (2 * d.L + 1) * d.H  # noqa: E731
    total14 = work.matmul_params(d14) + embed(d14) + biases(d14) + norms(d14)
    total7 = work.matmul_params(d7) + embed(d7) + biases(d7) + norms(d7)
    assert total14 == pytest.approx(14.77e9, rel=2e-3)
    assert total7 == pytest.approx(7.62e9, rel=2e-3)
    assert d14.Nh // d14.Nkv == 5 and d7.Nh // d7.Nkv == 7
    assert json.loads((root / "BENCHMARK.json").read_text())["configs"][0]["reduced"] == []
