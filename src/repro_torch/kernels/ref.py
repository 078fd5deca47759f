"""Plain PyTorch versions of the kernels K1–K6.

Each function computes what its CUDA kernel in ``csrc/mixed_res.cu``
(K1–K3), ``csrc/quant_pack.cu`` (K4–K5) or ``csrc/flash_decode.cu``
(K6) computes, with the same
arithmetic as the jnp oracles in ``repro/kernels/ref.py`` (K5 in a
fixed fold order): the CPU path of the port, the reference the
kernels are held to on the card, and the twin the parity tests hold
against the JAX package.

torch has no ``<<``/``>>`` on uint32, so packing runs in int64 and the
planes cross to uint32 at the boundary (:func:`to_u32`/:func:`from_u32`,
bit reinterpretations through int32, which every device supports).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from .mixed_res import (H_DBAR, H_DWQ, H_INF, H_LAM, H_STEP, HEADER_LANES,
                        code_width)


def to_u32(v: torch.Tensor) -> torch.Tensor:
    """int64 holding values in [0, 2**32) -> uint32, bit for bit."""
    signed = v - ((v >> 31) & 1) * (1 << 32)
    return signed.to(torch.int32).view(torch.uint32)


def from_u32(words: torch.Tensor) -> torch.Tensor:
    """uint32 -> int64 in [0, 2**32), bit for bit."""
    return words.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _valid(W: int, d_valid: int, device) -> torch.Tensor:
    return torch.arange(W * 128, device=device).reshape(1, W, 128) < d_valid


def _lane(head: torch.Tensor, lane: int) -> torch.Tensor:
    return head[:, lane].reshape(-1, 1, 1)


def _pack(bits: torch.Tensor, width: int) -> torch.Tensor:
    """[..., n] int64 values of ``width`` bits -> [..., n*width/32]
    uint32 words, slot k of each word at bit ``k * width``."""
    per = 32 // width
    shifts = torch.arange(per, device=bits.device, dtype=torch.int64) * width
    words = bits.reshape(*bits.shape[:-1], -1, per) << shifts
    return to_u32(words.sum(-1))


def _unpack(words: torch.Tensor, width: int) -> torch.Tensor:
    """Inverse of :func:`_pack`: [..., m] uint32 -> [..., m*32/width]
    int64 values."""
    per = 32 // width
    shifts = torch.arange(per, device=words.device, dtype=torch.int64) * width
    vals = (from_u32(words)[..., None] >> shifts) & ((1 << width) - 1)
    return vals.reshape(*words.shape[:-1], -1)


def signpack_ref(x: torch.Tensor) -> torch.Tensor:
    """K4.  x: [N, 128] f32 -> words [N, 4] uint32; bit j of word c is
    ``x[:, 32c + j] > 0`` (0 for -0.0, +0.0 and NaN; 1 for a positive
    subnormal, which XLA on the CPU flushes to 0)."""
    return _pack((x > 0).to(torch.int64), 1)


def sign_dequant_reduce_ref(words: torch.Tensor, scales: torch.Tensor
                            ) -> torch.Tensor:
    """K5.  words: [G, W, 4] uint32, scales: [G] f32 -> [W, 128] f32
    ``sum_g (bit ? scale_g : -scale_g)``.

    The peers fold left to right, ``((u_0 + u_1) + u_2) + ...``, not in
    one einsum: the CUDA kernel folds in the same order, so the two
    agree bit for bit."""
    G, W, _ = words.shape

    def one(g):
        bit = _unpack(words[g], 1).reshape(W, 128) > 0
        return torch.where(bit, scales[g], -scales[g])

    out = one(0)
    for g in range(1, G):
        out = out + one(g)
    return out


_F32_INF_BITS = 0x7F800000


def _f32(bits: int) -> np.float32:
    return np.array(bits, dtype=np.uint32).view(np.float32)[()]


def threshold_cutoff(inf: float, lam: float) -> Tuple[float, float]:
    """The threshold rule as a range: ``(lo, hi)`` such that, for every
    f32 ``a = |x|``, ``lo <= a <= hi`` exactly when ``a / safe_inf >=
    lam`` in f32 (``safe_inf = inf`` if ``inf > 0`` else 1).

    A correctly rounded division is monotone in its numerator, so for a
    finite ``safe_inf`` the passing set is ``[t*, +inf]``, ``t*`` the
    least passing bit pattern, found here by bisection over the patterns
    of ``[0, +inf]``; K1 and K2 find the same ``t*`` (a warp tests 32
    patterns a round).  ``safe_inf = +inf`` sends finite ``a`` to 0 and
    ``+inf`` to NaN: the set is ``[0, FLT_MAX]`` when ``0 >= lam``.  An
    empty set is ``(nan, nan)``; a NaN ``a`` never passes."""
    inf32, lam32 = np.float32(inf), np.float32(lam)
    c = inf32 if inf32 > 0 else np.float32(1.0)
    nan = (math.nan, math.nan)
    if np.isinf(c):
        return (0.0, float(np.finfo(np.float32).max)) \
            if np.float32(0.0) >= lam32 else nan

    def passes(bits: int) -> bool:
        with np.errstate(over="ignore", under="ignore"):
            return bool(_f32(bits) / c >= lam32)

    if not passes(_F32_INF_BITS):
        return nan
    if passes(0):
        return (0.0, math.inf)
    lo, hi = 1, _F32_INF_BITS          # the least passing is in [lo, hi]
    while lo < hi:
        mid = (lo + hi) // 2
        if passes(mid):
            hi = mid
        else:
            lo = mid + 1
    return (float(_f32(hi)), math.inf)


def mixed_res_reduce_ref(x: torch.Tensor, lam: float, d_valid: int
                         ) -> torch.Tensor:
    """K1, pass A.  x: [U, W, 128] f32 -> stats [U, 8] f32: lane H_INF
    ``||x||_inf``, H_DWQ the threshold-masked min (``+inf`` when no
    element qualifies), H_DBAR the high-resolution count."""
    U, W, _ = x.shape
    lam32 = float(np.float32(lam))
    absx = torch.abs(x)
    inf = torch.amax(absx, dim=(1, 2))
    safe_inf = torch.where(inf > 0, inf, 1.0)
    hi = (absx / safe_inf[:, None, None]) >= lam32
    if d_valid != W * 128:
        hi = hi & _valid(W, d_valid, x.device)
    dwq_raw = torch.amin(torch.where(hi, absx, torch.inf), dim=(1, 2))
    dbar = hi.sum(dim=(1, 2)).to(torch.float32)
    stats = torch.zeros((U, HEADER_LANES), dtype=torch.float32,
                        device=x.device)
    stats[:, H_INF] = inf
    stats[:, H_DWQ] = dwq_raw
    stats[:, H_DBAR] = dbar
    return stats


def mixed_res_emit_ref(x: torch.Tensor, head: torch.Tensor, b: int,
                       d_valid: int, *, anchored: bool = False):
    """K2, pass B.  x: [U, W, 128], head: [U, 8] -> (signs [U, W, 4],
    hi [U, W, 4], codes [U, W, 4*bw]) uint32 planes.

    ``anchored=False`` is the paper's threshold rule (lane H_LAM);
    ``anchored=True`` the static-budget rule ``|x| >= dw_q``."""
    U, W, _ = x.shape
    absx = torch.abs(x)
    dw_q, step = _lane(head, H_DWQ), _lane(head, H_STEP)
    safe_step = torch.where(step > 0, step, 1.0)
    if anchored:
        hi = absx >= dw_q
    else:
        inf = _lane(head, H_INF)
        safe_inf = torch.where(inf > 0, inf, 1.0)
        hi = (absx / safe_inf) >= _lane(head, H_LAM)
    if d_valid != W * 128:
        hi = hi & _valid(W, d_valid, x.device)
    # clamped to the grid top so an underestimated anchor never spills
    # bits into the neighbouring code slots
    code = torch.round((absx - dw_q) / safe_step)
    code = torch.clamp(torch.where(hi, code, 0.0), max=float(2 ** b - 1))
    code = code.to(torch.int64)
    signs = _pack((x > 0).to(torch.int64), 1)
    return signs, _pack(hi.to(torch.int64), 1), _pack(code, code_width(b))


def mixed_res_dequant_reduce_ref(signs: torch.Tensor, hi: torch.Tensor,
                                 codes: torch.Tensor, head: torch.Tensor,
                                 weights: torch.Tensor, b: int,
                                 acc: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """K3.  G users' planes -> [W, 128] f32
    ``(acc +) sum_g w_g * sign_g * (hi ? dw_q + code*step : dw_q/2)``.

    The users fold left to right with ``w`` folded into the grid
    scalars, ``((acc + u_0) + u_1) + ...``, the order of the jnp
    oracle; the CUDA kernel folds in the same order without
    contraction, so the two agree bit for bit."""
    G, W, _ = signs.shape
    bw = code_width(b)

    def one(g):
        sb = _unpack(signs[g], 1).reshape(W, 128) > 0
        him = _unpack(hi[g], 1).reshape(W, 128) > 0
        code = _unpack(codes[g], bw).reshape(W, 128).to(torch.float32)
        wdq = weights[g] * head[g, H_DWQ]
        wst = weights[g] * head[g, H_STEP]
        mag = torch.where(him, wdq + code * wst, wdq * 0.5)
        return torch.where(sb, mag, -mag)

    out = one(0) if acc is None else acc + one(0)
    for g in range(1, G):
        out = out + one(g)
    return out


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: Union[int, torch.Tensor]) -> torch.Tensor:
    """K6.  Single-token decode attention, the twin of the JAX
    package's ``flash_decode_ref``.

    q: [B, Hkv, G, D]; k: [B, Hkv, S, D]; v: [B, Hkv, S, Dv] (any
    strides); length: int or int tensor — positions >= length are
    masked out.  Float32 inside; returns [B, Hkv, G, Dv] in q's dtype."""
    S, D = k.shape[2], q.shape[-1]
    scores = torch.einsum("bhgd,bhsd->bhgs", q.float(), k.float())
    scores = scores / torch.full_like(scores, math.sqrt(D))
    length = torch.as_tensor(length, device=q.device)
    mask = torch.arange(S, device=q.device) < length
    scores = torch.where(mask, scores, -math.inf)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgs,bhsv->bhgv", w, v.float()).to(q.dtype)
