"""The command: no card, no result; and a whole tiny run on the CPU past the
look for a card, broken underneath, comes out not correct."""

import copy
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from servebench import check

from .conftest import TINY_MIXES, run_tiny

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--workload", "qwen25_14b-chat", "--seed", str(2**33 + 11), "--seconds", "1",
        "--trace", "0"]


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    out = subprocess.run([sys.executable, "-m", "servebench", *ARGS], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "servebench", tmp_path / "servebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "servebench", *ARGS], capture_output=True,
                         text=True, cwd=tmp_path, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_unknown_workload_no_result():
    out = subprocess.run([sys.executable, "-m", "servebench", "--workload", "nope", "--seed",
                          "1", "--seconds", "1"], capture_output=True, text=True, cwd=ROOT,
                         timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_sound_tiny_run_is_correct(tiny_mix):
    limits = check.load_limits("qwen25_14b-chat")
    if tiny_mix["loop"] == "open":
        limits = {"greedy_gap_mean": limits["greedy_gap_mean"]}
    result, lines, items = run_tiny(tiny_mix, limits=limits)
    assert result["correct"], lines
    assert result["failed"] == 0 and result["attempted"] > len(items) > 0
    assert list(result)[-1] == "check"
    json.dumps(result)


def test_altered_tokens_are_not_correct(monkeypatch, tiny_mix):
    """A token altered where it is produced (each row's choice moved to the
    next id) fails the check."""
    from llm_sharding_tpu_torch.parallel import serve

    real = serve._sample_rows

    def altered(state, rows, logits):
        return (real(state, rows, logits) + 1) % logits.shape[-1]

    monkeypatch.setattr(serve, "_sample_rows", altered)
    result, lines, _ = run_tiny(tiny_mix, limits=check.load_limits("qwen25_14b-chat"))
    assert not result["correct"], lines


def test_a_sampler_that_ignores_top_p_is_not_correct(monkeypatch):
    """Sampled requests served without top-p fail the check, which holds
    them to the request as sent. (A sampler at temperature 1 instead of the
    request's 0.7 reads past the limit at the chat cell's size, not at this
    one's 512 tokens: ``PERF.md`` has both readings.)"""
    from llm_sharding_tpu_torch.runtime import server

    real = server.PipelineServer.submit

    def submit(self, prompt, max_new, **kw):
        if kw.get("temperature", 0.0) > 0:
            kw["top_p"] = 1.0
        return real(self, prompt, max_new, **kw)

    monkeypatch.setattr(server.PipelineServer, "submit", submit)
    mix = copy.deepcopy(TINY_MIXES["closed"])
    mix.update(output={"dist": "lognormal", "median": 48, "sigma": 0.2, "min": 40, "max": 60},
               check={"greedy_random": 0, "sampled_random": 4})
    mix["server"]["kv_blocks"] = 33
    result, lines, _ = run_tiny(mix, seconds=2.0, limits=check.load_limits("qwen25_14b-chat"))
    assert not result["correct"], lines
