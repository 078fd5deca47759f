"""The flash-decode attention kernel K6, written by hand in CUDA C++ for
Hopper (``csrc/flash_decode.cu``), and its wrapper.

:func:`flash_decode` replaces ``repro/kernels/flash_decode.py``
``flash_decode``: one query token per (batch, kv head) carrying its
GQA group, attending over the cache positions < ``length`` with an
online softmax — the serve path's decode attention.  k and v are read
through their strides, so the op hands over the ``[B, S, Hkv, D]``
cache as a transposed view and nothing is copied.

The launch depends on shapes alone: the kernel reads ``length`` from
the card and sizes its split of the cache there (:func:`split_ranges`
is the same arithmetic), so a CUDA graph replays one call at any length
and the host never syncs.  One launch a call and one output tensor: the
splits of a (batch, kv head) merge inside a thread-block cluster.

A wrapper given CPU tensors runs the plain version in ``ref.py``; given
CUDA tensors it launches the kernel on the current stream or raises.
It counts its launches in :data:`LAUNCHES` (``"flash_decode"``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, List, Tuple, Union

import torch

from . import launch as _l
from .launch import LAUNCHES

TILE = 64            # positions per tile: 8 warps of 8, one ring stage
MIN_CHUNK = 128      # least positions a split takes before another starts
CLUSTER_MAX = 8      # splits of one (b, h): one cluster, portable size
G_MAX, D_MAX, DV_SUPPORTED = 8, 256, (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_SIGNATURES = (
    ("fd_flash_decode", (_l.I, _l.P, _l.P, _l.P, _l.P, _l.P, _l.I, _l.I,
                         _l.I, _l.I, _l.I, _l.I, _l.I, _l.LL, _l.LL, _l.LL,
                         _l.LL, _l.LL, _l.LL, _l.P)),
    ("fd_occupancy", (_l.I, _l.I, _l.I, _l.I, _l.I, _l.I, _l.I, _l.P, _l.P,
                      _l.P)),
)


def _library():
    return _l.library("flash_decode.cu", "fd_error_string", _SIGNATURES)


def build_info():
    """Build (at first use) and load the kernel; the build record."""
    return _library()[1]


def split_count(B: int, Hkv: int, S: int,
                clusters_of: Callable[[int], int]) -> int:
    """Blocks per (b, h), from shapes and the card alone: the most, up to
    :data:`CLUSTER_MAX` and no more than S has chunks of
    :data:`MIN_CHUNK`, for which all B*Hkv clusters are resident at
    once (``clusters_of(n)``: clusters of n blocks the card holds), so
    the grid runs in one wave; 1 when even that takes more than one
    wave.  The grid is (nsplit, Hkv, B); each (b, h)'s nsplit blocks
    form one cluster."""
    top = max(1, min(CLUSTER_MAX, -(-S // MIN_CHUNK)))
    for n in range(top, 1, -1):
        if B * Hkv <= clusters_of(n):
            return n
    return 1


def split_ranges(length: int, S: int,
                 nsplit: int) -> Tuple[int, List[Tuple[int, int]]]:
    """(n_eff, [(start, end) for each split]): the kernel's own range
    arithmetic, which each block does on the device from ``*length``.
    The ``ceil(len / TILE)`` tiles below ``len = clamp(length, 0, S)``
    are shared evenly over the first ``n_eff = clamp(ceil(len /
    MIN_CHUNK), 1, nsplit)`` splits, in whole tiles; the rest get an
    empty range and read nothing."""
    n = min(S, max(int(length), 0))
    tiles = -(-n // TILE)
    n_eff = min(max(-(-n // MIN_CHUNK), 1), nsplit)
    per, rem = divmod(tiles, n_eff)
    ranges = []
    for i in range(nsplit):
        if i >= n_eff:
            ranges.append((0, 0))
            continue
        t0 = i * per + min(i, rem)
        t1 = t0 + per + (1 if i < rem else 0)
        ranges.append((t0 * TILE, min(t1 * TILE, n)))
    return n_eff, ranges


def _occupancy(dtype: torch.dtype, B: int, Hkv: int, G: int, D: int,
               Dv: int, nsplit: int) -> Tuple[int, int, int]:
    vals = [ctypes.c_int(0) for _ in range(3)]
    _l.launch(_library(), "fd_occupancy", _DTYPES[dtype], B, Hkv, G, D, Dv,
              nsplit, *(ctypes.addressof(x) for x in vals))
    return tuple(x.value for x in vals)


@functools.lru_cache(maxsize=None)
def _split_on(device: int, dtype: torch.dtype, B: int, Hkv: int, G: int,
              D: int, Dv: int, S: int) -> int:
    """:func:`split_count` on the current card (asked once a shape)."""
    return split_count(B, Hkv, S, lambda n: _occupancy(
        dtype, B, Hkv, G, D, Dv, n)[1])


def occupancy(dtype: torch.dtype, B: int, Hkv: int, G: int, D: int,
              Dv: int, S: int) -> Dict[str, int]:
    """K6's residency on the current card at a shape: blocks an SM
    holds, clusters the card holds at once, a block's dynamic shared
    memory, and the grid."""
    nsplit = _split_on(torch.cuda.current_device(), dtype, B, Hkv, G, D,
                       Dv, S)
    per_sm, clusters, smem = _occupancy(dtype, B, Hkv, G, D, Dv, nsplit)
    return {"blocks_per_sm": per_sm, "clusters": clusters,
            "smem_bytes": smem, "nsplit": nsplit,
            "grid_blocks": nsplit * Hkv * B}


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
    out = torch.empty((B, Hkv, G, Dv), dtype=q.dtype, device=dev)
    ksb, ksh, kss, _ = k.stride()
    vsb, vsh, vss, _ = v.stride()
    with torch.cuda.device(dev):
        nsplit = _split_on(dev.index, q.dtype, B, Hkv, G, D, Dv, S)
        _l.launch(_library(), "fd_flash_decode", _DTYPES[q.dtype],
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), len_t.data_ptr(),
                  out.data_ptr(), B, Hkv, G, D, Dv, S, nsplit, ksb, kss, ksh,
                  vsb, vss, vsh, _l.stream())
    LAUNCHES["flash_decode"] += 1
    return out
