"""The flash-decode attention kernel K6, written by hand in CUDA C++ for
Hopper (``csrc/flash_decode.cu``), and its wrapper.

:func:`flash_decode` replaces ``repro/kernels/flash_decode.py``
``flash_decode``: one query token per (batch, kv head) carrying its
GQA group, attending over the cache positions < ``length`` with an
online softmax — the serve path's decode attention.  k and v are read
through their strides, so the op hands over the ``[B, S, Hkv, D]``
cache as a transposed view and nothing is copied.

A wrapper given CPU tensors runs the plain version in ``ref.py``; given
CUDA tensors it launches the kernel on the current stream or raises.
It counts its launches in :data:`LAUNCHES` (``"flash_decode"``).
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from . import launch as _l
from .launch import LAUNCHES

WARPS, TILE = 4, 32          # the kernel's warps per block, positions per warp step
TARGET_BLOCKS = 132 * 8      # about eight blocks per SM of an H100
G_MAX, D_MAX, DV_SUPPORTED = 8, 256, (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_SIGNATURES = (
    ("fd_flash_decode", (_l.I, _l.P, _l.P, _l.P, _l.P, _l.P, _l.P, _l.P,
                         _l.P, _l.I, _l.I, _l.I, _l.I, _l.I, _l.I, _l.I,
                         _l.I, _l.LL, _l.LL, _l.LL, _l.LL, _l.LL, _l.LL,
                         _l.P)),
)


def _library():
    return _l.library("flash_decode.cu", "fd_error_string", _SIGNATURES)


def build_info():
    """Build (at first use) and load the kernel; the build record."""
    return _library()[1]


def split_plan(B: int, Hkv: int, S: int) -> Tuple[int, int]:
    """(chunk, nsplit): S is cut into ``nsplit`` chunks of ``chunk``
    positions (a multiple of a block's 128-position sweep), one block
    each, so that the grid has about :data:`TARGET_BLOCKS` blocks when
    B*Hkv alone would leave SMs idle."""
    sweep = WARPS * TILE
    want = min(max(1, -(-TARGET_BLOCKS // (B * Hkv))), -(-S // sweep))
    chunk = -(-S // want)
    chunk = -(-chunk // sweep) * sweep
    return chunk, -(-S // chunk)


def _length_on(length: Union[int, torch.Tensor], device) -> torch.Tensor:
    """``length`` as one int32 on ``device`` (a device tensor stays
    where it is, so reading it never syncs the host)."""
    if isinstance(length, torch.Tensor):
        if length.numel() != 1:
            raise ValueError(f"length must hold one value, got shape "
                             f"{tuple(length.shape)}")
        if length.device != device:
            raise ValueError(f"length is on {length.device}, expected "
                             f"{device}")
        return length.to(torch.int32).reshape(1).contiguous()
    return torch.tensor([int(length)], dtype=torch.int32, device=device)


def _check_rows(t: torch.Tensor, name: str, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]):
        raise ValueError(f"{name} needs a contiguous last dim and strides "
                         f"in multiples of 8 elements, got {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start 16-byte aligned")


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 length: Union[int, torch.Tensor]) -> torch.Tensor:
    """K6.  q: [B, Hkv, G, D]; k: [B, Hkv, S, D]; v: [B, Hkv, S, Dv]
    (any strides with the last dim contiguous); length: int or one-int
    tensor on q's device — positions >= length are masked.  Returns
    [B, Hkv, G, Dv] in q's dtype."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-d [B, Hkv, G|S, D]")
    B, Hkv, G, D = q.shape
    S, Dv = k.shape[2], v.shape[3]
    if tuple(k.shape) != (B, Hkv, S, D) or tuple(v.shape[:3]) != (B, Hkv, S):
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if not _l.on_cuda(q):
        from .ref import flash_decode_ref
        return flash_decode_ref(q, k, v, length)
    dev = q.device
    if q.dtype not in _DTYPES:
        raise ValueError(f"K6 takes float32 or bfloat16, got {q.dtype}")
    if G > G_MAX or D > D_MAX or D % 8 or Dv not in DV_SUPPORTED or S < 1:
        raise ValueError(f"K6 takes G <= {G_MAX}, D a multiple of 8 up to "
                         f"{D_MAX}, Dv in {DV_SUPPORTED}, S >= 1; got G={G} "
                         f"D={D} Dv={Dv} S={S}")
    _l.check(q, "q", q.dtype, (B, Hkv, G, D), dev)
    _check_rows(k, "k", q.dtype, dev)
    _check_rows(v, "v", q.dtype, dev)
    len_t = _length_on(length, dev)
    chunk, nsplit = split_plan(B, Hkv, S)
    out = torch.empty((B, Hkv, G, Dv), dtype=q.dtype, device=dev)
    part_ml = torch.empty((B * Hkv, nsplit, 2, G), dtype=torch.float32,
                          device=dev)
    part_acc = torch.empty((B * Hkv, nsplit, G, Dv), dtype=torch.float32,
                           device=dev)
    counters = torch.zeros(B * Hkv, dtype=torch.int32, device=dev)
    ksb, ksh, kss, _ = k.stride()
    vsb, vsh, vss, _ = v.stride()
    with torch.cuda.device(dev):
        _l.launch(_library(), "fd_flash_decode", _DTYPES[q.dtype],
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), len_t.data_ptr(),
                  out.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr(),
                  counters.data_ptr(), B, Hkv, G, D, Dv, S, chunk, nsplit,
                  ksb, kss, ksh, vsb, vss, vsh, _l.stream())
    LAUNCHES["flash_decode"] += 1
    return out
