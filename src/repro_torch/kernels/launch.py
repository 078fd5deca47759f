"""What every CUDA kernel wrapper of the port shares: the launch
counters, loading a built source through ctypes, launching on the
current stream, and the input checks.

Each source under ``csrc/`` exposes a plain C interface whose entry
points return ``cudaGetLastError()`` after their launches, and one
``<prefix>_error_string(int)``; :func:`launch` raises on a non-zero
return.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Sequence, Tuple

import torch

from . import build as _build

# CUDA launches per kernel (K1 is two launches: max, then threshold);
# a wrapper counts here where it launches its kernel, and nowhere else
LAUNCHES: Dict[str, int] = {"mixed_res_reduce": 0, "mixed_res_emit": 0,
                            "mixed_res_dequant_reduce": 0, "signpack": 0,
                            "sign_dequant_reduce": 0, "flash_decode": 0}

P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def library(source: str, error_fn: str,
            signatures: Tuple[Tuple[str, Tuple], ...]):
    """Build ``csrc/<source>`` (at first use) and load it; every entry
    point in ``signatures`` (name, argtypes) returns an int error."""
    info = _build.build(source)
    lib = ctypes.CDLL(str(info.path))
    for name, argtypes in signatures:
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    err = getattr(lib, error_fn)
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib, info, err


def launch(loaded, name: str, *args) -> None:
    """Call entry point ``name`` of a :func:`library` result; raise on
    the CUDA error it returns."""
    lib, _, err_fn = loaded
    err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{err_fn(err).decode()}")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(t: torch.Tensor, name: str, dtype, shape: Sequence[int],
          device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def on_cuda(t: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version runs); True for a CUDA
    tensor (the kernel runs); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no CUDA kernel for device {t.device}")
    return True
