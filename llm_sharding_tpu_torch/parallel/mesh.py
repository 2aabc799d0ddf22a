"""Device grids (the port of ``llm_sharding_tpu/parallel/mesh.py`` and of
``hybrid_mesh`` in ``parallel/distributed.py:46-60``).

The JAX package lays its devices out as a ``jax.sharding.Mesh`` whose axes
name the parallel strategies. The port runs one process that issues every
device's work, so a grid is a nested list of ``torch.device``s in the
same order: axis 0 outermost. The hybrid axis order is the JAX one,
``(data, pipe, seq, tensor)``, tensor innermost: a stage's tensor group is
``tp`` consecutive devices of the list, and ``devices = dp × stages ×
tp``; a context-parallel server's grid is ``(cp, pipe)``. An explicit device list is honoured verbatim and may repeat a
device (one card standing in for several).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .pipeline import visible_devices
from .tensor import TENSOR_AXIS

PIPE_AXIS = "pipe"  # pipeline-chain axis
DATA_AXIS = "data"  # data-parallel axis: replicas of the chain
SEQ_AXIS = "seq"  # sequence/context-parallel axis (ring attention)
CP_AXIS = "cp"  # serve-side context-parallel axis (the sharded arena)


class Grid:
    """A device grid: ``devices`` (an object array of ``torch.device``s)
    under ``axis_names``; ``shape`` maps each name to its size, as a JAX
    ``Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names: tuple):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def device_list(self) -> list:
        """The devices in grid order (axis 0 outermost)."""
        return list(self.devices.reshape(-1))


def _device_grid(shape: tuple, devices: Optional[Sequence]) -> np.ndarray:
    """``prod(shape)`` devices as an object array of ``shape``: the first
    of ``devices`` in order (default every visible GPU), repeats allowed
    (``mesh.py:27-50``)."""
    need = int(np.prod(shape))
    devs = visible_devices(None if devices is None else list(devices))
    if len(devs) < need:
        raise ValueError(f"mesh {shape} needs {need} devices, have {len(devs)}")
    arr = np.empty(need, dtype=object)
    arr[:] = devs[:need]
    return arr.reshape(shape)


def pipeline_data_mesh(num_stages: int, data_parallel: int,
                       devices: Optional[Sequence] = None) -> Grid:
    """2-D grid: the chain ``data_parallel`` times, pipe minor
    (``mesh.py:74-85``)."""
    return Grid(_device_grid((data_parallel, num_stages), devices), (DATA_AXIS, PIPE_AXIS))


def pipeline_cp_mesh(cp: int, num_stages: int, devices: Optional[Sequence] = None) -> Grid:
    """2-D grid for context-parallel serving (``mesh.py:61``): ``cp``
    copies of the chain, pipe minor, each holding one shard of every
    stage's paged arena; stage ``i``'s shard group is column ``i``. Pass the
    engine's own devices, so a replica builds its grid from its slice of
    the machine."""
    return Grid(_device_grid((cp, num_stages), devices), (CP_AXIS, PIPE_AXIS))


def hybrid_mesh(*, data: int = 1, pipe: int = 1, seq: int = 1, tensor: int = 1,
                devices: Optional[Sequence] = None) -> Grid:
    """4-D grid over ``(data, pipe, seq, tensor)``, tensor innermost
    (``distributed.py:46-60``)."""
    return Grid(_device_grid((data, pipe, seq, tensor), devices),
                (DATA_AXIS, PIPE_AXIS, SEQ_AXIS, TENSOR_AXIS))
