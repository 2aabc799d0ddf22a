"""Placement: which contiguous layer range each pipeline stage holds (the
port of ``llm_sharding_tpu/parallel/placement.py``, whole).

A ``PlacementSpec`` maps stage ``i`` of the chain to its ``[start, end)``
layer range, with the JAX package's validation and error messages.
Stage 0 takes the requests; the final norm and the head are sharded by
vocab over every stage (``parallel/head.py``). Ragged splits (the
reference's 6/1/25) are plain here: a stage on its own device holds just
its layers, so nothing is padded to a common depth and no layer is masked
(``split_stage_layers``). ``max_layers_per_stage`` keeps its meaning for
the callers that pad a stage on purpose (``utils/shard_store.load_stage``).

This module is not the placement PLANNER (``runtime/placement.py``),
which proposes fleet layouts from a profile.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class PlacementSpec:
    """``stages[i]`` = the ``(start, end)`` layer range of pipeline stage
    ``i``, in chain order, over a ``num_layers``-layer model."""

    stages: tuple  # tuple[tuple[int, int], ...]
    num_layers: int

    def __post_init__(self):
        object.__setattr__(self, "stages", tuple((int(a), int(b)) for a, b in self.stages))
        self.validate()

    def validate(self) -> None:
        if not self.stages:
            raise ValueError("placement needs at least one stage")
        prev_end = 0
        for i, (start, end) in enumerate(self.stages):
            if not (0 <= start < end <= self.num_layers):
                raise ValueError(
                    f"stage {i}: invalid layer range [{start}, {end}) for "
                    f"{self.num_layers}-layer model"
                )
            if start != prev_end:
                raise ValueError(
                    f"stage {i} starts at layer {start}, but previous stage "
                    f"ended at {prev_end}: chain must cover layers contiguously"
                )
            prev_end = end
        if prev_end != self.num_layers:
            raise ValueError(
                f"chain covers layers [0, {prev_end}) but the model has "
                f"{self.num_layers} layers"
            )

    @property
    def num_stages(self) -> int:
        return len(self.stages)

    @property
    def max_layers_per_stage(self) -> int:
        return max(end - start for start, end in self.stages)

    @classmethod
    def balanced(cls, num_layers: int, num_stages: int) -> "PlacementSpec":
        """Even split; the earlier stages take the remainder."""
        if num_stages < 1 or num_stages > num_layers:
            raise ValueError(f"num_stages must be in [1, {num_layers}], got {num_stages}")
        base, rem = divmod(num_layers, num_stages)
        stages, cursor = [], 0
        for i in range(num_stages):
            n = base + (1 if i < rem else 0)
            stages.append((cursor, cursor + n))
            cursor += n
        return cls(tuple(stages), num_layers)

    @classmethod
    def from_ranges(cls, ranges: Sequence[tuple[int, int]], num_layers: int) -> "PlacementSpec":
        return cls(tuple(ranges), num_layers)

    def grouped(self, k: int) -> "PlacementSpec":
        """Merge ``k`` consecutive stages per device: how a chain longer
        than the device list runs. Stages are contiguous, so each merged
        group is one contiguous range and the tokens are the chain's."""
        if k < 1 or self.num_stages % k:
            raise ValueError(f"{self.num_stages} stages cannot group by {k} per device")
        merged = tuple(
            (self.stages[i * k][0], self.stages[i * k + k - 1][1])
            for i in range(self.num_stages // k)
        )
        return PlacementSpec(merged, self.num_layers)

    @classmethod
    def from_capabilities(cls, num_layers: int, capabilities: Sequence[float]) -> "PlacementSpec":
        """Capability-weighted ragged split: ``capabilities[i]`` is stage
        ``i``'s throughput proxy (higher is faster); layers are allocated
        in proportion (contiguous, at least one per stage), the rounding
        drift repaired toward the proportional target."""
        caps = np.asarray(capabilities, np.float64)
        if caps.ndim != 1 or len(caps) < 1:
            raise ValueError("capabilities must be a 1-D sequence")
        if np.any(caps <= 0):
            raise ValueError(f"capabilities must be positive, got {caps}")
        S = len(caps)
        if S > num_layers:
            raise ValueError(f"{S} stages > {num_layers} layers")
        raw = caps / caps.sum() * num_layers
        counts = np.maximum(1, np.round(raw).astype(int))
        while counts.sum() > num_layers:
            over = counts - raw  # the most over-allocated stage gives one back
            over[counts <= 1] = -np.inf
            counts[int(np.argmax(over))] -= 1
        while counts.sum() < num_layers:
            counts[int(np.argmin(counts - raw))] += 1
        stages, cursor = [], 0
        for n in counts:
            stages.append((cursor, cursor + int(n)))
            cursor += int(n)
        return cls(tuple(stages), num_layers)

    @classmethod
    def from_stage_times(cls, num_layers: int, stage_times: Sequence[float]) -> "PlacementSpec":
        """Split from measured per-stage (equal-layer) times: a stage that
        measured twice as slow gets about half the layers."""
        t = np.asarray(stage_times, np.float64)
        return cls.from_capabilities(num_layers, 1.0 / t)


def split_stage_layers(spec: PlacementSpec, layers: list) -> list:
    """The full model's per-layer list cut into one list per stage (the
    counterpart of JAX ``stack_stage_params``, ``placement.py:169``, with
    no padding: a stage holds exactly its ``end - start`` layers)."""
    if len(layers) != spec.num_layers:
        raise ValueError(
            f"placement covers {spec.num_layers} layers but the model has {len(layers)}"
        )
    return [list(layers[start:end]) for start, end in spec.stages]
