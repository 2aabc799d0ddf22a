"""Shared pieces of the benchmark's CPU tests: a tiny qwen2 configuration
and tiny mixes in the shapes of the cells' own."""

import copy
import time

import pytest
import torch

torch.set_num_threads(2)

TINY_CFG = {
    "model_type": "qwen2", "vocab_size": 512, "hidden_size": 64, "intermediate_size": 128,
    "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
    "max_position_embeddings": 512, "rms_norm_eps": 1e-6, "rope_theta": 1e6,
    "tie_word_embeddings": False, "bos_token_id": 510, "eos_token_id": 511,
}

_SERVER = {"batch_per_slot": 4, "capacity": 128, "kv_block_size": 16, "kv_blocks": 21,
           "prefill_chunk": 32, "prefix_cache": "off"}

TINY_MIXES = {
    "closed": {
        "loop": "closed", "clients": 4, "round": 4,
        "prompt": {"dist": "lognormal", "median": 24, "sigma": 0.5, "min": 8, "max": 60},
        "output": {"dist": "lognormal", "median": 8, "sigma": 0.4, "min": 4, "max": 12},
        "sampling": {"temperature": 0.7, "top_k": 20, "top_p": 0.8, "greedy_per_round": 2},
        "steady_start": "residual", "server": _SERVER,
        "check": {"greedy_random": 2, "sampled_random": 2},
    },
    "open": {
        "loop": "open", "rate": 20.0, "lead_seconds": 0.3, "round": 8,
        "prompt": {"dist": "lognormal", "median": 30, "sigma": 0.5, "min": 8, "max": 60},
        "output": {"dist": "lognormal", "median": 6, "sigma": 0.4, "min": 4, "max": 12},
        "sampling": {"temperature": 0.0}, "cache_fill": {"prompt": 32, "wave": 4},
        "server": dict(_SERVER, prefix_cache="hbm"),
        "check": {"greedy_random": 3},
    },
}

LOOSE = {"greedy_gap_mean": 0.1, "topk_gap": 1.0}


@pytest.fixture
def tiny_cfg():
    return copy.deepcopy(TINY_CFG)


@pytest.fixture(params=sorted(TINY_MIXES))
def tiny_mix(request):
    return copy.deepcopy(TINY_MIXES[request.param])


def run_tiny(mix, seed=7, seconds=1.0, limits=LOOSE, metric_specs=None, kind="end_to_end"):
    """A whole run of a tiny cell on the CPU, past the harness's look for a
    card."""
    from servebench import run

    return run.run_cell(copy.deepcopy(TINY_CFG), mix, limits, seed, seconds, False,
                        time.perf_counter(), device="cpu", metric_specs=metric_specs, kind=kind)


@pytest.fixture
def card():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
