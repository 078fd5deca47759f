"""The sign-plane wire kernels K4–K5, written by hand in CUDA C++ for
Hopper (``csrc/quant_pack.cu``), and their wrappers.

* K4 :func:`signpack` — the 1-bit sign plane of ``[N, 128]`` f32 rows
  (replaces ``repro/kernels/quant_pack.py`` ``signpack``);
* K5 :func:`sign_dequant_reduce` — unpacks G peers' sign planes and
  sums them with per-peer scales (replaces ``sign_dequant_reduce``).

Layout (the JAX package's): bit j of packed word c of a row is element
``32c + j``, 1 meaning ``x > 0``.  Any row count is taken: the JAX
kernel's ``W % block_rows`` rule is a TPU tiling constraint.

A wrapper given CPU tensors runs the plain version in ``ref.py``; given
CUDA tensors it launches its kernel on the current stream or raises.
Each counts its kernel launches in :data:`LAUNCHES`.
"""
from __future__ import annotations

import torch

from . import launch as _l
from .launch import LAUNCHES

_SIGNATURES = (
    ("qp_signpack", (_l.P, _l.P, _l.LL, _l.P)),
    ("qp_sign_dequant_reduce", (_l.P, _l.P, _l.P, _l.I, _l.LL, _l.P)),
)


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
    ``sum_g (bit ? scale_g : -scale_g)``, peers folded left to right."""
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
    out = torch.empty((W, 128), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _l.launch(_library(), "qp_sign_dequant_reduce", words.data_ptr(),
                  scales.data_ptr(), out.data_ptr(), G, W, _l.stream())
    LAUNCHES["sign_dequant_reduce"] += 1
    return out
