"""Device selection and the typed "not in this port slice" error.

Every entry point of the port resolves its device here: the default is the
GPU, the CPU only when the caller asks for it (the CPU tests do), and a
missing GPU is an error, never a silent fallback.
"""

from __future__ import annotations

from typing import Optional, Union

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
