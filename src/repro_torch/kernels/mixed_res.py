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

import functools
from typing import Optional

import numpy as np
import torch

from . import launch as _l
from .launch import LAUNCHES

# wire-header lanes ([U, 8] f32 scalar rows); lanes 5-7 stay zero (the
# JAX package's checksum lane H_CHK = 5 is not ported)
H_INF, H_DWQ, H_STEP, H_DBAR, H_LAM = 0, 1, 2, 3, 4
HEADER_LANES = 8

CODE_STORE_WIDTHS = (2, 4, 8, 16)


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
_SIGNATURES = (
    ("mr_reduce", (_l.P, _l.P, _l.I, _l.LL, _l.LL, _l.F, _l.P)),
    ("mr_emit", (_l.P, _l.P, _l.P, _l.P, _l.P, _l.I, _l.LL, _l.LL, _l.I,
                 _l.I, _l.P)),
    ("mr_dequant_reduce", (_l.P, _l.P, _l.P, _l.P, _l.P, _l.P, _l.P, _l.I,
                           _l.LL, _l.I, _l.P)),
)


def _library():
    return _l.library("mixed_res.cu", "mr_error_string", _SIGNATURES)


def build_info():
    """Build (at first use) and load the kernels; the build record."""
    return _library()[1]


def _launch(name: str, *args) -> None:
    _l.launch(_library(), name, *args)


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
    if not _l.on_cuda(x):
        from .ref import mixed_res_reduce_ref
        return mixed_res_reduce_ref(x, lam, d_valid)
    _l.check(x, "x", torch.float32, (U, W, 128), x.device)
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (K1 loads float4)")
    head = torch.zeros((U, HEADER_LANES), dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        _launch("mr_reduce", x.data_ptr(), head.data_ptr(), U, W,
                int(d_valid), float(np.float32(lam)), _l.stream())
    LAUNCHES["mixed_res_reduce"] += 2
    return head


def mixed_res_emit(x: torch.Tensor, head: torch.Tensor, b: int,
                   d_valid: int, *, anchored: bool = False):
    """K2.  x: [U, W, 128] f32, head: [U, 8] f32 -> (signs [U, W, 4],
    hi [U, W, 4], codes [U, W, 4*bw]) uint32.  ``anchored=False`` is the
    paper's threshold rule (lane H_LAM), ``anchored=True`` the
    static-budget rule ``|x| >= dw_q``."""
    U, W = _check_rows(x, d_valid)
    if not _l.on_cuda(x):
        from .ref import mixed_res_emit_ref
        return mixed_res_emit_ref(x, head, b, d_valid, anchored=anchored)
    _l.check(x, "x", torch.float32, (U, W, 128), x.device)
    _l.check(head, "head", torch.float32, (U, HEADER_LANES), x.device)
    new = functools.partial(torch.empty, dtype=torch.uint32,
                            device=x.device)
    signs, hi, codes = new((U, W, 4)), new((U, W, 4)), \
        new((U, W, code_words_per_row(b)))
    with torch.cuda.device(x.device):
        _launch("mr_emit", x.data_ptr(), head.data_ptr(), signs.data_ptr(),
                hi.data_ptr(), codes.data_ptr(), U, W, int(d_valid), b,
                int(anchored), _l.stream())
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
    if not _l.on_cuda(signs):
        from .ref import mixed_res_dequant_reduce_ref
        return mixed_res_dequant_reduce_ref(signs, hi, codes, head,
                                            weights, b, acc=acc)
    dev = signs.device
    _l.check(signs, "signs", torch.uint32, (G, W, 4), dev)
    _l.check(hi, "hi", torch.uint32, (G, W, 4), dev)
    _l.check(codes, "codes", torch.uint32, (G, W, code_words_per_row(b)),
             dev)
    _l.check(head, "head", torch.float32, (G, HEADER_LANES), dev)
    _l.check(weights, "weights", torch.float32, (G,), dev)
    if acc is not None:
        _l.check(acc, "acc", torch.float32, (W, 128), dev)
    out = torch.empty((W, 128), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("mr_dequant_reduce", signs.data_ptr(), hi.data_ptr(),
                codes.data_ptr(), head.data_ptr(), weights.data_ptr(),
                None if acc is None else acc.data_ptr(), out.data_ptr(),
                G, W, b, _l.stream())
    LAUNCHES["mixed_res_dequant_reduce"] += 1
    return out
