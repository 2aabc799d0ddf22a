"""Build, load and launch the port's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C entry point, compiled
by ``nvcc`` for ``sm_90a`` into its own shared library and called through
``ctypes`` (no PyTorch headers, so a build takes seconds). Libraries go to
``build/kernels/`` at the repository root, named by a hash of the sources
and flags: the first use after a source change rebuilds, later uses load.
``build_all`` starts one ``nvcc`` per missing library at once.

Nothing here runs at import: the CPU tests import every module, and this
machine-independent part is all they touch.

Each ``CudaKernel`` keeps a ``launches`` counter per KV mode (``""`` for
an arena in the query dtype, ``"int8"``, ``"fp8"``) that its wrapper's
launch path adds one to, and nothing else does; ``launch_counts`` names a
quantized mode ``"paged_attention[int8]"`` once it has launched.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
HEADERS = ("attn_tile.cuh", "hopper.cuh", "wgmma_attn.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# after the source: hopper.cuh finds libcuda's cuTensorMapEncodeTiled with dlsym
LINK_FLAGS = ("-ldl",)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the head dims every kernel is instantiated for (256: gemma-1)
HEAD_DIMS = (64, 128, 256)
# 1-byte KV storage of the paged kernels: (kernel code, launch-count mode);
# an arena in the query dtype is (0, "")
KV_STORAGE = {torch.int8: (1, "int8"), torch.float8_e4m3fn: (2, "fp8")}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


class CudaKernel:
    """One ``csrc`` source, its C entry point and its launch counter."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = collections.Counter()
        self.build_log = ""
        self._fn = None
        self._lib = None

    def library_path(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
        for name in (self.source, *HEADERS):
            h.update((CSRC_DIR / name).read_bytes())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def nvcc_command(self, out: Path) -> list:
        return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC_DIR / self.source), *LINK_FLAGS]

    def _load(self):
        if self._fn is None:
            path = self.library_path()
            if not path.exists():
                build_all([self])
            lib = ctypes.CDLL(str(path))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            lib.attn_error_string.argtypes = [ctypes.c_int]
            lib.attn_error_string.restype = ctypes.c_char_p
            self._lib, self._fn = lib, fn
        return self._fn

    def launch(self, *args, mode: str = "") -> None:
        """Call the C entry point on the current stream's work; raise if the
        launch was refused or an earlier asynchronous fault surfaced."""
        rc = self._load()(*args)
        if rc != 0:
            msg = self._lib.attn_error_string(rc).decode()
            raise RuntimeError(f"{self.name} kernel launch failed ({rc}): {msg}")
        self.launches[mode] += 1


FLASH = CudaKernel(
    "flash_attention", "flash_attention.cu", "flash_attention_fwd",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P],
)
PAGED_DECODE = CudaKernel(
    "paged_attention", "paged_attention.cu", "paged_attention_fwd",
    [_P] * 11 + [_I] * 9 + [_F, _I, _I, _P],
)
PAGED_PREFILL = CudaKernel(
    "paged_prefill", "paged_prefill.cu", "paged_prefill_fwd",
    [_P] * 12 + [_I] * 9 + [_F, _I, _I, _I, _P],
)
KERNELS = (FLASH, PAGED_DECODE, PAGED_PREFILL)


def build_all(kernels=KERNELS) -> float:
    """Compile every kernel whose library is missing, one ``nvcc`` each, all
    started together; returns the wall seconds spent. Raises with the
    compiler's output if any build fails. Each library is written under a
    temporary name and renamed into place, so concurrent builders never
    load a half-written file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for k in kernels:
        path = k.library_path()
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        p = subprocess.Popen(
            k.nvcc_command(tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        procs.append((k, p, tmp, path))
    failed = []
    for k, p, tmp, path in procs:
        out, _ = p.communicate()
        k.build_log = out
        if p.returncode != 0:
            failed.append(f"--- {k.source} (nvcc exit {p.returncode})\n{out}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches.clear()


def launch_counts() -> dict:
    """``{kernel name: launches with an arena in the query dtype}``, plus
    ``"name[mode]"`` for each quantized mode that has launched."""
    out = {k.name: k.launches[""] for k in KERNELS}
    for k in KERNELS:
        out.update({f"{k.name}[{m}]": n for m, n in k.launches.items() if m})
    return out


def kv_storage(arena: torch.Tensor) -> tuple[int, str]:
    """The paged kernels' KV storage code of an arena and its launch-count
    mode: ``(0, "")``, ``(1, "int8")`` or ``(2, "fp8")``."""
    return KV_STORAGE.get(arena.dtype, (0, ""))


def current_stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (the split-KV planner's
    input)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_operand(
    name: str, t: torch.Tensor, device: torch.device,
    dtype: Optional[torch.dtype] = None, shape: Optional[tuple] = None, align: int = 16,
) -> None:
    """Raise on what the kernels do not take: another device, dtype, shape,
    a non-contiguous layout or a base address that is not ``align``-byte
    aligned (the kernels read K/V/Q rows with 16-byte loads)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def int32_operand(name: str, t: torch.Tensor, shape: tuple, device) -> torch.Tensor:
    """A position, table or count operand as the kernels take it."""
    if t.dtype != torch.int32:
        raise ValueError(f"{name} must be int32, got {t.dtype}")
    t = t.contiguous()
    check_operand(name, t, device, torch.int32, shape)
    return t


def check_attention_inputs(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None, v_scale: Optional[torch.Tensor] = None,
) -> int:
    """Shared q/k/v checks; returns the kernel dtype code. K/V are in the
    query dtype, or (paged kernels) 1-byte int8/fp8 codes that come with
    contiguous f32 scales ``[NB, Nkv]``, and scales come with nothing else."""
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"attention kernels take float32 or bfloat16, got {q.dtype}")
    D = q.shape[-1]
    if D not in HEAD_DIMS:
        raise ValueError(f"attention kernels take head_dim 64, 128 or 256, got {D}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"{q.shape[2]} query heads not a multiple of {k.shape[2]} KV heads")
    quantized = k.dtype in KV_STORAGE
    if quantized != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError(
            f"a {k.dtype} arena needs k_scale and v_scale exactly when it holds 1-byte "
            f"int8/fp8 codes (got k_scale={'set' if k_scale is not None else None}, "
            f"v_scale={'set' if v_scale is not None else None})"
        )
    check_operand("q", q, q.device)
    check_operand("k", k, q.device, k.dtype if quantized else q.dtype)
    check_operand("v", v, q.device, k.dtype, tuple(k.shape))
    if quantized:
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            check_operand(name, s, q.device, torch.float32, (k.shape[0], k.shape[2]), align=4)
    if k.shape[-1] != D:
        raise ValueError(f"k head_dim {k.shape[-1]} != q head_dim {D}")
    return DTYPE_CODES[q.dtype]
