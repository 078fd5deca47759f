"""The mixed-resolution wire kernels K1–K3, written by hand in CUDA C++
for Hopper (``csrc/mixed_res.cu``), and their wrappers.

* K1 :func:`mixed_res_reduce` — pass A: per-user ``||x||_inf``, then the
  threshold-masked min ``dw_q`` and the high-resolution count ``dbar``
  (replaces ``repro/kernels/mixed_res.py`` ``mixed_res_reduce``); one
  thread-block cluster a user stages the user's row in shared memory,
  so x is read from device memory once (:func:`reduce_config`,
  :func:`rank_rows`);
* K2 :func:`mixed_res_emit` — pass B: sign, hi and b-bit code planes
  (replaces ``mixed_res_emit``);
* K3 :func:`mixed_res_dequant_reduce` — fused decode of G users' planes
  and their weighted sum (replaces ``mixed_res_dequant_reduce``).

Layout (the JAX package's): a flat f32 vector is viewed as ``[W, 128]``
rows; bit j of packed word c is element ``32c + j``, 1 meaning
``x > 0`` in the sign plane; the code plane holds ``32 // bw`` codes a
word, slot k at bit ``k * bw``, where ``bw`` is the storage width.

K1 and K2 decide the threshold rule ``|x| / safe_inf >= lam`` without a
division, by a per-user cutoff (``ref.threshold_cutoff`` is the plain
twin of the search they run; :func:`cutoffs` runs it on the card).

A wrapper given CPU tensors runs the plain version in ``ref.py``; given
CUDA tensors it launches its kernel on the current stream or raises.
Each counts its kernel launches in :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from . import launch as _l
from .launch import LAUNCHES

# wire-header lanes ([U, 8] f32 scalar rows); lanes 5-7 stay zero (the
# JAX package's checksum lane H_CHK = 5 is not ported)
H_INF, H_DWQ, H_STEP, H_DBAR, H_LAM = 0, 1, 2, 3, 4
HEADER_LANES = 8

CODE_STORE_WIDTHS = (2, 4, 8, 16)

# K1: a user's rows go to the ranks of its cluster in whole tiles of 16
# rows (8 KB); a block stages at most K1_STAGE_TILES of them in shared
# memory (56 KB, so three blocks share an SM) and streams the rest
K1_TILE_ROWS = 16
K1_CLUSTER_SIZES = (16, 8, 4, 2, 1)
K1_STAGE_TILES = 7
# the kernels do their row arithmetic in 32 bits: d < 2**24 pads to at
# most 2**17 rows
MAX_ROWS = 2 ** 17
# K1 and K2 put the users on gridDim.y, so one launch takes at most this
# many; the wrappers launch more in chunks (:func:`user_chunks`)
MAX_USERS_PER_LAUNCH = 65535


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
    ("mr_reduce", (_l.P, _l.P, _l.I, _l.I, _l.I, _l.F, _l.I, _l.I, _l.P)),
    ("mr_reduce_occupancy", (_l.I, _l.I, _l.P, _l.P)),
    ("mr_emit", (_l.P, _l.P, _l.P, _l.P, _l.P, _l.I, _l.I, _l.I, _l.I,
                 _l.I, _l.P)),
    ("mr_cutoffs", (_l.P, _l.P, _l.P, _l.I, _l.P)),
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
    return U, W


def user_chunks(U: int) -> List[Tuple[int, int]]:
    """[(u0, u1)]: ``range(U)`` cut into the fewest consecutive chunks
    of at most :data:`MAX_USERS_PER_LAUNCH` users, their sizes within one
    of each other.  Users are independent in K1 and K2, so a launch a
    chunk gives the bits of one launch over all users."""
    n = -(-U // MAX_USERS_PER_LAUNCH)
    per, rem = divmod(U, n)
    bounds = [0]
    for i in range(n):
        bounds.append(bounds[-1] + per + (1 if i < rem else 0))
    return list(zip(bounds[:-1], bounds[1:]))


def _check_kernel_rows(x: torch.Tensor, U: int, W: int) -> None:
    _l.check(x, "x", torch.float32, (U, W, 128), x.device)
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (the kernels load "
                         "float4)")
    if W > MAX_ROWS:
        raise ValueError(f"the kernels take at most {MAX_ROWS} rows a "
                         f"user, got W={W}")


# ------------------------------------------------------------ K1 layout
def rank_rows(W: int, n: int) -> List[Tuple[int, int]]:
    """[(row0, row1) for each rank of a user's cluster of n blocks]: the
    kernel's own partition.  The ``ceil(W / K1_TILE_ROWS)`` tiles are
    shared evenly over the ranks in whole tiles, the first ``T % n``
    ranks one more; a rank past the last tile gets an empty range."""
    T = -(-W // K1_TILE_ROWS)
    per, rem = divmod(T, n)
    out = []
    for r in range(n):
        t0 = r * per + min(r, rem)
        t1 = t0 + per + (1 if r < rem else 0)
        out.append((min(t0 * K1_TILE_ROWS, W), min(t1 * K1_TILE_ROWS, W)))
    return out


def reduce_config(W: int, clusters_of: Callable[[int, int], int]
                  ) -> Tuple[int, int]:
    """(n, cap) for K1 at W rows: the largest cluster size n in
    :data:`K1_CLUSTER_SIZES` that the card places (``clusters_of(n,
    cap)``: clusters it holds at once, each block staging ``cap``
    tiles), ``cap`` the busiest rank's tiles, at most
    :data:`K1_STAGE_TILES`.  Raises when the card places none."""
    T = -(-W // K1_TILE_ROWS)
    for n in K1_CLUSTER_SIZES:
        cap = min(K1_STAGE_TILES, -(-T // n))
        if clusters_of(n, cap) >= 1:
            return n, cap
    raise RuntimeError(f"the card places no K1 cluster at W={W}")


def reduce_occupancy(n: int, cap: int) -> Tuple[int, int]:
    """(clusters the current card holds at once, blocks an SM holds) for
    K1 with clusters of n blocks, each staging ``cap`` tiles."""
    vals = [ctypes.c_int(0) for _ in range(2)]
    _launch("mr_reduce_occupancy", n, cap,
            *(ctypes.addressof(v) for v in vals))
    return vals[0].value, vals[1].value


@functools.lru_cache(maxsize=None)
def _config_on(device: int, W: int) -> Tuple[int, int]:
    """:func:`reduce_config` on a card, asked once a shape (so a CUDA
    graph can capture the launch)."""
    with torch.cuda.device(device):
        return reduce_config(W, lambda n, cap: reduce_occupancy(n, cap)[0])


# ------------------------------------------------------------ wrappers
def mixed_res_reduce(x: torch.Tensor, lam: float, d_valid: int
                     ) -> torch.Tensor:
    """K1.  x: [U, W, 128] f32 -> stats [U, 8] f32 (lanes H_INF, H_DWQ
    raw — ``+inf`` when no element clears the threshold — and H_DBAR;
    the rest 0); ``d_valid`` is the unpadded length.  One launch a chunk
    of :func:`user_chunks` (U = 65,536 counts 2 in :data:`LAUNCHES`)."""
    U, W = _check_rows(x, d_valid)
    if not _l.on_cuda(x):
        from .ref import mixed_res_reduce_ref
        return mixed_res_reduce_ref(x, lam, d_valid)
    return _reduce(x, lam, d_valid, *_config_on(x.device.index, W))


def _reduce(x: torch.Tensor, lam: float, d_valid: int, n: int,
            cap: int) -> torch.Tensor:
    """K1 on CUDA tensors at cluster size ``n`` and staging depth ``cap``."""
    U, W = x.shape[0], x.shape[1]
    _check_kernel_rows(x, U, W)
    head = torch.empty((U, HEADER_LANES), dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        for u0, u1 in user_chunks(U):
            _launch("mr_reduce", x[u0:u1].data_ptr(), head[u0:u1].data_ptr(),
                    u1 - u0, W, int(d_valid), float(np.float32(lam)), n, cap,
                    _l.stream())
            LAUNCHES["mixed_res_reduce"] += 1
    return head


def mixed_res_emit(x: torch.Tensor, head: torch.Tensor, b: int,
                   d_valid: int, *, anchored: bool = False):
    """K2.  x: [U, W, 128] f32, head: [U, 8] f32 -> (signs [U, W, 4],
    hi [U, W, 4], codes [U, W, 4*bw]) uint32.  ``anchored=False`` is the
    paper's threshold rule (lane H_LAM), ``anchored=True`` the
    static-budget rule ``|x| >= dw_q``.  One launch a chunk of
    :func:`user_chunks`."""
    U, W = _check_rows(x, d_valid)
    if not _l.on_cuda(x):
        from .ref import mixed_res_emit_ref
        return mixed_res_emit_ref(x, head, b, d_valid, anchored=anchored)
    _check_kernel_rows(x, U, W)
    _l.check(head, "head", torch.float32, (U, HEADER_LANES), x.device)
    new = functools.partial(torch.empty, dtype=torch.uint32,
                            device=x.device)
    signs, hi, codes = new((U, W, 4)), new((U, W, 4)), \
        new((U, W, code_words_per_row(b)))
    with torch.cuda.device(x.device):
        for u0, u1 in user_chunks(U):
            _launch("mr_emit", x[u0:u1].data_ptr(), head[u0:u1].data_ptr(),
                    *(p[u0:u1].data_ptr() for p in (signs, hi, codes)),
                    u1 - u0, W, int(d_valid), b, int(anchored), _l.stream())
            LAUNCHES["mixed_res_emit"] += 1
    return signs, hi, codes


def cutoffs(inf: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """The cutoff search K1 and K2 run, one per pair: inf, lam [n] f32 ->
    [n, 2] f32 (lo, hi) — ``lo <= |x| <= hi`` exactly when
    ``|x| / safe_inf >= lam`` in f32.  CPU tensors take the plain twin
    ``ref.threshold_cutoff``; CUDA tensors one launch of the search
    (a check of the search, not a step of any path: uncounted)."""
    if inf.dim() != 1 or inf.shape != lam.shape or inf.numel() < 1:
        raise ValueError(f"inf and lam must be [n >= 1], got "
                         f"{tuple(inf.shape)} and {tuple(lam.shape)}")
    if not _l.on_cuda(inf):
        from .ref import threshold_cutoff
        return torch.tensor([threshold_cutoff(float(i), float(m))
                             for i, m in zip(inf.tolist(), lam.tolist())],
                            dtype=torch.float32).reshape(-1, 2)
    n = inf.numel()
    _l.check(inf, "inf", torch.float32, (n,), inf.device)
    _l.check(lam, "lam", torch.float32, (n,), inf.device)
    out = torch.empty((n, 2), dtype=torch.float32, device=inf.device)
    with torch.cuda.device(inf.device):
        _launch("mr_cutoffs", inf.data_ptr(), lam.data_ptr(), out.data_ptr(),
                n, _l.stream())
    return out


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
