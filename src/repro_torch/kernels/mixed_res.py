"""The mixed-resolution wire kernels K1–K3, written by hand in CUDA C++
for Hopper (``csrc/mixed_res.cu``), and their wrappers.

* K1 :func:`mixed_res_reduce` — pass A: per-user ``||x||_inf``, then the
  threshold-masked min ``dw_q`` and the high-resolution count ``dbar``
  (replaces ``repro/kernels/mixed_res.py`` ``mixed_res_reduce``);
* K2 :func:`mixed_res_emit` — pass B: sign, hi and b-bit code planes
  (replaces ``mixed_res_emit``);
* K3 :func:`mixed_res_dequant_reduce` — fused decode of G users' planes
  and their weighted sum (replaces ``mixed_res_dequant_reduce``).

Layout (the JAX package's): a flat f32 vector is viewed as ``[W, 128]``
rows; bit j of packed word c is element ``32c + j``, 1 meaning
``x > 0`` in the sign plane; the code plane holds ``32 // bw`` codes a
word, slot k at bit ``k * bw``, where ``bw`` is the storage width.

A wrapper given CPU tensors runs the plain version in ``ref.py``; given
CUDA tensors it launches its kernel on the current stream or raises.
Each counts its kernel launches in :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import numpy as np
import torch

from . import build as _build

# wire-header lanes ([U, 8] f32 scalar rows); lanes 5-7 stay zero (the
# JAX package's checksum lane H_CHK = 5 is not ported)
H_INF, H_DWQ, H_STEP, H_DBAR, H_LAM = 0, 1, 2, 3, 4
HEADER_LANES = 8

CODE_STORE_WIDTHS = (2, 4, 8, 16)

# CUDA launches per kernel (K1 is two launches: max, then threshold)
LAUNCHES: Dict[str, int] = {"mixed_res_reduce": 0, "mixed_res_emit": 0,
                            "mixed_res_dequant_reduce": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def code_width(b: int) -> int:
    """Storage width for b-bit codes: smallest of {2,4,8,16} >= b."""
    for w in CODE_STORE_WIDTHS:
        if w >= b:
            return w
    raise ValueError(f"wire kernels store codes in <= 16 bits, got b={b}")


def code_words_per_row(b: int) -> int:
    """uint32 words per 128-lane row of the packed code plane."""
    return 128 * code_width(b) // 32


# ------------------------------------------------------------ loading
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float


@functools.lru_cache(maxsize=None)
def _library():
    info = _build.build("mixed_res.cu")
    lib = ctypes.CDLL(str(info.path))
    lib.mr_reduce.argtypes = [_P, _P, _I, _LL, _LL, _F, _P]
    lib.mr_emit.argtypes = [_P, _P, _P, _P, _P, _I, _LL, _LL, _I, _I, _P]
    lib.mr_dequant_reduce.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _LL,
                                      _I, _P]
    for fn in (lib.mr_reduce, lib.mr_emit, lib.mr_dequant_reduce):
        fn.restype = ctypes.c_int
    lib.mr_error_string.argtypes = [ctypes.c_int]
    lib.mr_error_string.restype = ctypes.c_char_p
    return lib, info


def build_info() -> _build.BuildInfo:
    """Build (at first use) and load the kernels; the build record."""
    return _library()[1]


def _launch(name: str, *args) -> None:
    lib, _ = _library()
    err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.mr_error_string(err).decode()}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_cuda(t: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version runs); True for a CUDA
    tensor (the kernel runs); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no mixed-res kernel for device {t.device}")
    return True


def _check_rows(x: torch.Tensor, d_valid: int):
    if x.dim() != 3 or x.shape[2] != 128:
        raise ValueError(f"x must be [U, W, 128], got {tuple(x.shape)}")
    U, W, _ = x.shape
    if not 0 < d_valid <= W * 128:
        raise ValueError(f"d_valid={d_valid} outside (0, {W * 128}]")
    if d_valid >= 2 ** 24:
        raise ValueError("f32 dbar accumulator is exact only to 2**24")
    if U > 65535:
        raise ValueError(f"at most 65535 users per launch, got {U}")
    return U, W


# ------------------------------------------------------------ wrappers
def mixed_res_reduce(x: torch.Tensor, lam: float, d_valid: int
                     ) -> torch.Tensor:
    """K1.  x: [U, W, 128] f32 -> stats [U, 8] f32 (lanes H_INF, H_DWQ
    raw — ``+inf`` when no element clears the threshold — and H_DBAR);
    ``d_valid`` is the unpadded length."""
    U, W = _check_rows(x, d_valid)
    if not _on_cuda(x):
        from .ref import mixed_res_reduce_ref
        return mixed_res_reduce_ref(x, lam, d_valid)
    _check(x, "x", torch.float32, (U, W, 128), x.device)
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (K1 loads float4)")
    head = torch.zeros((U, HEADER_LANES), dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        _launch("mr_reduce", x.data_ptr(), head.data_ptr(), U, W,
                int(d_valid), float(np.float32(lam)), _stream())
    LAUNCHES["mixed_res_reduce"] += 2
    return head


def mixed_res_emit(x: torch.Tensor, head: torch.Tensor, b: int,
                   d_valid: int, *, anchored: bool = False):
    """K2.  x: [U, W, 128] f32, head: [U, 8] f32 -> (signs [U, W, 4],
    hi [U, W, 4], codes [U, W, 4*bw]) uint32.  ``anchored=False`` is the
    paper's threshold rule (lane H_LAM), ``anchored=True`` the
    static-budget rule ``|x| >= dw_q``."""
    U, W = _check_rows(x, d_valid)
    if not _on_cuda(x):
        from .ref import mixed_res_emit_ref
        return mixed_res_emit_ref(x, head, b, d_valid, anchored=anchored)
    _check(x, "x", torch.float32, (U, W, 128), x.device)
    _check(head, "head", torch.float32, (U, HEADER_LANES), x.device)
    new = functools.partial(torch.empty, dtype=torch.uint32,
                            device=x.device)
    signs, hi, codes = new((U, W, 4)), new((U, W, 4)), \
        new((U, W, code_words_per_row(b)))
    with torch.cuda.device(x.device):
        _launch("mr_emit", x.data_ptr(), head.data_ptr(), signs.data_ptr(),
                hi.data_ptr(), codes.data_ptr(), U, W, int(d_valid), b,
                int(anchored), _stream())
    LAUNCHES["mixed_res_emit"] += 1
    return signs, hi, codes


def mixed_res_dequant_reduce(signs: torch.Tensor, hi: torch.Tensor,
                             codes: torch.Tensor, head: torch.Tensor,
                             weights: torch.Tensor, b: int, *,
                             acc: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """K3.  signs/hi: [G, W, 4] u32, codes: [G, W, 4*bw] u32, head:
    [G, 8] f32, weights: [G] f32 (, acc: [W, 128] f32) -> [W, 128] f32
    ``(acc +) sum_g w_g * deq(wire_g)``, users folded left to right."""
    if signs.dim() != 3 or signs.shape[0] < 1:
        raise ValueError(f"signs must be [G>=1, W, 4], got "
                         f"{tuple(signs.shape)}")
    G, W, _ = signs.shape
    if not _on_cuda(signs):
        from .ref import mixed_res_dequant_reduce_ref
        return mixed_res_dequant_reduce_ref(signs, hi, codes, head,
                                            weights, b, acc=acc)
    dev = signs.device
    _check(signs, "signs", torch.uint32, (G, W, 4), dev)
    _check(hi, "hi", torch.uint32, (G, W, 4), dev)
    _check(codes, "codes", torch.uint32, (G, W, code_words_per_row(b)), dev)
    _check(head, "head", torch.float32, (G, HEADER_LANES), dev)
    _check(weights, "weights", torch.float32, (G,), dev)
    if acc is not None:
        _check(acc, "acc", torch.float32, (W, 128), dev)
    out = torch.empty((W, 128), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("mr_dequant_reduce", signs.data_ptr(), hi.data_ptr(),
                codes.data_ptr(), head.data_ptr(), weights.data_ptr(),
                None if acc is None else acc.data_ptr(), out.data_ptr(),
                G, W, b, _stream())
    LAUNCHES["mixed_res_dequant_reduce"] += 1
    return out
