"""The sign-plane wire kernels K4–K5, written by hand in CUDA C++ for
Hopper (``csrc/quant_pack.cu``), and their wrappers.

* K4 :func:`signpack` — the 1-bit sign plane of ``[N, 128]`` f32 rows
  (replaces ``repro/kernels/quant_pack.py`` ``signpack``);
* K5 :func:`sign_dequant_reduce` — unpacks G peers' sign planes and
  sums them with per-peer scales (replaces ``sign_dequant_reduce``);
  :data:`K5_LANES` lanes serve a row and each warp stages its rows'
  words in shared memory, a stage of peers at a time
  (:func:`sign_reduce_plan`, :func:`staging_order`).

Layout (the JAX package's): bit j of packed word c of a row is element
``32c + j``, 1 meaning ``x > 0``.  Any row count is taken: the JAX
kernel's ``W % block_rows`` rule is a TPU tiling constraint.

A wrapper given CPU tensors runs the plain version in ``ref.py``; given
CUDA tensors it launches its kernel on the current stream or raises.
Each counts its kernel launches in :data:`LAUNCHES`.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import launch as _l
from .launch import LAUNCHES

# K5's launch, as ``csrc/quant_pack.cu`` holds it: K5_LANES lanes serve
# a row (128 / K5_LANES outputs a lane, 32 / K5_LANES rows a warp), a
# block owns K5_ROWS rows, and each warp stages K5_LANES peers a stage
# (one 16-byte piece a lane); the entry point refuses any other plan
K5_LANES = 16
K5_ROWS = 8

_SIGNATURES = (
    ("qp_signpack", (_l.P, _l.P, _l.LL, _l.P)),
    ("qp_sign_dequant_reduce", (_l.P, _l.P, _l.P, _l.I, _l.LL, _l.I, _l.I,
                                _l.LL, _l.P)),
)


class SignReducePlan(NamedTuple):
    """K5's launch at G peers and W rows."""
    G: int
    W: int
    rows: int       # rows a block (the last block may hold fewer)
    lanes: int      # lanes a row
    blocks: int     # ceil(W / rows)
    chunks: int     # stages of ``chunk`` peers, the last may hold fewer

    @property
    def chunk(self) -> int:
        """Peers a stage: one 16-byte piece a lane."""
        return self.lanes

    @property
    def rows_a_warp(self) -> int:
        return 32 // self.lanes


def sign_reduce_plan(G: int, W: int) -> SignReducePlan:
    """The launch the wrapper asks of K5: it depends on the shapes
    alone, so a CUDA graph can capture it."""
    if G < 1 or W < 1:
        raise ValueError(f"K5 needs G >= 1 peers and W >= 1 rows, got "
                         f"G={G}, W={W}")
    return SignReducePlan(G, W, K5_ROWS, K5_LANES, -(-W // K5_ROWS),
                          -(-G // K5_LANES))


def staging_order(plan: SignReducePlan) -> Tuple[np.ndarray, np.ndarray]:
    """(g, row) of every 16-byte piece K5 stages, in its order: block by
    block, warp by warp, stage by stage, lane by lane.  Lane i of warp v
    of block b at stage k copies peer ``k * chunk + i // rpw`` of row
    ``b * rows + v * rpw + i % rpw`` (rpw rows a warp) when both exist
    — the twin of the kernel's copies."""
    rpw = plan.rows_a_warp
    b = np.arange(plan.blocks, dtype=np.int64)[:, None, None, None]
    v = np.arange(plan.rows // rpw, dtype=np.int64)[None, :, None, None]
    k = np.arange(plan.chunks, dtype=np.int64)[None, None, :, None]
    i = np.arange(32, dtype=np.int64)[None, None, None, :]
    g = k * plan.chunk + i // rpw
    row = b * plan.rows + v * rpw + i % rpw
    g, row = np.broadcast_arrays(g, row)
    keep = (g < plan.G) & (row < plan.W)
    return g[keep], row[keep]


def _library():
    return _l.library("quant_pack.cu", "qp_error_string", _SIGNATURES)


def build_info():
    """Build (at first use) and load the kernels; the build record."""
    return _library()[1]


def signpack(x: torch.Tensor) -> torch.Tensor:
    """K4.  x: [N, 128] f32 -> [N, 4] uint32 packed sign plane."""
    if x.dim() != 2 or x.shape[1] != 128 or x.shape[0] < 1:
        raise ValueError(f"x must be [N>=1, 128], got {tuple(x.shape)}")
    if not _l.on_cuda(x):
        from .ref import signpack_ref
        return signpack_ref(x)
    N = x.shape[0]
    _l.check(x, "x", torch.float32, (N, 128), x.device)
    words = torch.empty((N, 4), dtype=torch.uint32, device=x.device)
    with torch.cuda.device(x.device):
        _l.launch(_library(), "qp_signpack", x.data_ptr(),
                  words.data_ptr(), N, _l.stream())
    LAUNCHES["signpack"] += 1
    return words


def sign_dequant_reduce(words: torch.Tensor, scales: torch.Tensor
                        ) -> torch.Tensor:
    """K5.  words: [G, W, 4] uint32, scales: [G] f32 -> [W, 128] f32
    ``sum_g (bit ? scale_g : -scale_g)``, peers folded left to right,
    the first term taken as it is.  One launch, planned by
    :func:`sign_reduce_plan`."""
    if words.dim() != 3 or words.shape[0] < 1 or words.shape[2] != 4:
        raise ValueError(f"words must be [G>=1, W, 4], got "
                         f"{tuple(words.shape)}")
    G, W, _ = words.shape
    if not _l.on_cuda(words):
        from .ref import sign_dequant_reduce_ref
        return sign_dequant_reduce_ref(words, scales)
    dev = words.device
    _l.check(words, "words", torch.uint32, (G, W, 4), dev)
    _l.check(scales, "scales", torch.float32, (G,), dev)
    if words.data_ptr() % 16:
        raise ValueError("words must be 16-byte aligned (K5 stages them "
                         "16 bytes at a time)")
    plan = sign_reduce_plan(G, W)
    out = torch.empty((W, 128), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _l.launch(_library(), "qp_sign_dequant_reduce", words.data_ptr(),
                  scales.data_ptr(), out.data_ptr(), G, W, plan.rows,
                  plan.chunk, plan.blocks, _l.stream())
    LAUNCHES["sign_dequant_reduce"] += 1
    return out
