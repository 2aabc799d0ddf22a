"""Device selection and the typed "not in this port slice" error.

Every entry point of the port resolves its device here: the default is the
GPU, the CPU only when the caller asks for it (the CPU tests do), and a
missing GPU is an error, never a silent fallback.
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import numpy as np
import torch


class NotPorted(NotImplementedError):
    """A feature of the JAX package that this slice of the port does not
    carry yet. The message names the later slice (``ROADMAP.md`` §A)."""


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device with no GPU present raises
    ``RuntimeError`` instead of falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev


def to_device(a, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A host array (numpy, list or scalar) as a tensor on ``device``
    without a stream sync. On the card the values go through a pinned
    staging copy taken now and a ``non_blocking`` copy: ``a`` may change
    as soon as this returns, and the copy is ordered behind the work
    already queued instead of waiting for it (a pageable copy would drain
    the stream first). On the CPU it is a plain copy."""
    t = torch.tensor(np.asarray(a))
    if dtype is not None:
        t = t.to(dtype)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def hop(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: itself where it is there already, else a
    ``non_blocking`` copy ordered behind the work that produced it (how a
    hidden state moves from one pipeline stage's device to the next)."""
    return t if t.device == device else t.to(device, non_blocking=True)


@functools.lru_cache(maxsize=None)
def device_const(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A constant (a scalar or a tuple of values) as a cached tensor on
    ``device``: the programs of a decode step read such constants (stop
    ids, RoPE frequencies) every step, and building them anew would copy
    host memory to the card each time. Do not write to the result."""
    return to_device(values, device, dtype)
