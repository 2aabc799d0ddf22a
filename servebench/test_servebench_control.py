"""The control at a size a test run holds: the reference with its matrices
in float8, put in the program's place at the same positions, reads worse
than the program on the numbers the chat cell compares, and the cell's
limits judge it not correct. On the card at the
cells' own sizes: ``python -m servebench.control`` (``PERF.md`` has its
readings)."""

import pytest
import torch

from servebench import check, weights

from .conftest import TINY_CFG, TINY_MIXES, run_tiny


@pytest.mark.parametrize("seed", [2, 2**40 + 7])
def test_the_control_reads_worse_than_the_program(seed):
    limits = check.load_limits("qwen25_14b-chat")
    result, lines, items = run_tiny(TINY_MIXES["closed"], seed=seed, seconds=1.5, limits=limits)
    assert result["correct"], lines
    d = weights.Dims.of(TINY_CFG)
    cpu = torch.device("cpu")
    control = check.gaps(d, seed, items, cpu, control=check.choices(d, seed, items, cpu, "fp8"))
    program = {k: v["value"] for k, v in result["check"].items()}
    assert control["topk_gap"] > max(program["topk_gap"], 0.05)
    assert control["greedy_gap_mean"] > program["greedy_gap_mean"]
    control_correct, control_lines = check.verdict(control, limits, 0)
    assert not control_correct, control_lines
