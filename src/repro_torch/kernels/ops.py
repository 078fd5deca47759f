"""The ops built on K1–K6: the wire paths (layout, encode, fused
reduce) and the serve path's decode attention.

Packed plane: ``mixed_res_encode`` turns U stacked deltas into packed
planes in two passes (K1, a scalar epilogue, K2);
``mixed_res_wire_reduce`` decodes and weights all users' planes in one
pass (K3).  Neither materializes a dense per-user reconstruction.

Sign plane: ``packed_sign_weighted_sum`` packs G sign planes in one K4
launch and reduces them with per-peer scales in one K5 launch.

Which lowering runs is the :class:`WirePath`'s ``lowering``, resolved
by the tensor's device.

Decode attention: ``flash_decode_op`` runs K6 on CUDA tensors and its
plain version on CPU tensors, over the ``[B, S, Hkv, D]`` KV cache.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from . import ref as _ref
from .flash_decode import flash_decode
from .mixed_res import (H_DBAR, H_DWQ, H_INF, H_LAM, H_STEP,
                        mixed_res_dequant_reduce, mixed_res_emit,
                        mixed_res_reduce)
from .quant_pack import sign_dequant_reduce, signpack
from .wire import WirePath, check_packed_dim


def true_div(x: torch.Tensor, n: float) -> torch.Tensor:
    """``x / n`` as an IEEE division on every device.  On CUDA, torch
    turns a division by a Python scalar into a multiplication by its
    reciprocal, which can round one ulp away from the JAX package's
    ``x / n``; a divisor tensor on ``x``'s device keeps the division."""
    return x / torch.full_like(x, n)


def sign_pad_len(d: int) -> int:
    """Padded length for viewing a flat d-vector as [W, 128] rows:
    W = ceil(d/128), padded up to a multiple of 256 rows once W
    exceeds 256 — the JAX package's layout, kept so planes compare
    word for word."""
    rows = -(-d // 128)
    if rows > 256 and rows % 256:
        rows = -(-rows // 256) * 256
    return rows * 128


def signpack_op(x: torch.Tensor, *, path: Optional[WirePath] = None
                ) -> torch.Tensor:
    """Pack the sign plane of a flat f32 vector.

    x: [d] f32 with d % 128 == 0  ->  [d/32] uint32 (viewed flat)."""
    path = path or WirePath()
    rows = x.to(torch.float32).reshape(-1, 128).contiguous()
    words = signpack(rows) if path.use_kernel(rows) \
        else _ref.signpack_ref(rows)
    return words.reshape(-1)


def sign_dequant_reduce_op(words: torch.Tensor, scales: torch.Tensor, *,
                           path: Optional[WirePath] = None
                           ) -> torch.Tensor:
    """words: [G, d/32] u32, scales: [G] -> [d] f32 weighted sign sum."""
    path = path or WirePath()
    G = words.shape[0]
    w3 = words.reshape(G, -1, 4).contiguous()
    s = scales.to(device=words.device, dtype=torch.float32).contiguous()
    out = sign_dequant_reduce(w3, s) if path.use_kernel(w3) \
        else _ref.sign_dequant_reduce_ref(w3, s)
    return out.reshape(-1)


def packed_sign_weighted_sum(flat: torch.Tensor, scales: torch.Tensor, *,
                             path: Optional[WirePath] = None
                             ) -> torch.Tensor:
    """flat: [G, d] f32, scales: [G] f32 -> [d] f32 equal to
    ``sum_g scales_g * sign(flat_g)`` with sign(x) = +1 iff x > 0.

    Routes through the packed wire format: the G sign planes, padded
    to :func:`sign_pad_len`, are stacked into ONE K4 launch over
    ``[G*rows, 128]``, and one K5 launch unpacks and reduces them."""
    path = path or WirePath()
    G, d = flat.shape
    rows = sign_pad_len(d) // 128
    words = signpack_op(wire_view(flat.to(torch.float32)).reshape(-1),
                        path=path)
    out = sign_dequant_reduce_op(words.reshape(G, rows * 4), scales,
                                 path=path)
    return out[:d]


class MixedResWire(NamedTuple):
    """Packed wire buffers for U stacked deltas: sign and hi planes
    ([U, W, 4] u32), b-bit magnitude codes ([U, W, 4*bw] u32) and the
    per-user header row ([U, 8] f32 — inf, dw_q, step, dbar, lambda)."""
    signs: torch.Tensor
    hi: torch.Tensor
    codes: torch.Tensor
    head: torch.Tensor


def wire_view(flat: torch.Tensor) -> torch.Tensor:
    """[U, d] f32 -> zero-padded [U, W, 128] rows (W per sign_pad_len)."""
    U, d = flat.shape
    d_pad = sign_pad_len(d)
    if d_pad != d:
        flat = F.pad(flat, (0, d_pad - d))
    return flat.reshape(U, d_pad // 128, 128)


def mixed_res_encode(flat: torch.Tensor, lambda_: float, b: int, *,
                     path: Optional[WirePath] = None) -> MixedResWire:
    """Threshold-rule (paper eq. 6) encode of U stacked deltas
    ``flat`` [U, d] straight to the packed wire format."""
    path = path or WirePath()
    flat = flat.to(torch.float32)
    U, d = flat.shape
    check_packed_dim(d, where="mixed_res_encode")
    x3 = wire_view(flat).contiguous()
    kern = path.use_kernel(x3)
    if kern:
        stats = mixed_res_reduce(x3, lambda_, d)
    else:
        stats = _ref.mixed_res_reduce_ref(x3, lambda_, d)
    # scalar epilogue — the JAX package's op sequence, in f32
    inf = stats[:, H_INF]
    dw_q_raw = stats[:, H_DWQ]
    dw_q = torch.where(torch.isfinite(dw_q_raw), dw_q_raw, 0.0)
    step = true_div(inf - dw_q, 2 ** b - 1)
    head = stats.clone()
    head[:, H_DWQ] = dw_q
    head[:, H_STEP] = step
    head[:, H_LAM] = float(np.float32(lambda_))
    if kern:
        signs, hi, codes = mixed_res_emit(x3, head, b, d)
    else:
        signs, hi, codes = _ref.mixed_res_emit_ref(x3, head, b, d)
    return MixedResWire(signs=signs, hi=hi, codes=codes, head=head)


def mixed_res_wire_reduce(wire: MixedResWire, weights: torch.Tensor,
                          b: int, d: int, *,
                          acc: Optional[torch.Tensor] = None,
                          path: Optional[WirePath] = None) -> torch.Tensor:
    """Fused decode + weighted reduce ``(acc +) sum_g w_g * deq(wire_g)``
    -> [d] f32, entirely from the packed buffers.  ``acc`` ([d] f32)
    seeds the left fold, so a user axis folded chunk by chunk gives
    the one-shot values."""
    path = path or WirePath()
    w = weights.to(device=wire.head.device, dtype=torch.float32)
    acc3 = None
    if acc is not None:
        acc3 = wire_view(acc.to(torch.float32)[None])[0].contiguous()
    if path.use_kernel(wire.head):
        out = mixed_res_dequant_reduce(wire.signs, wire.hi, wire.codes,
                                       wire.head, w.contiguous(), b,
                                       acc=acc3)
    else:
        out = _ref.mixed_res_dequant_reduce_ref(
            wire.signs, wire.hi, wire.codes, wire.head, w, b, acc=acc3)
    return out.reshape(-1)[:d]


def mixed_res_wire_aggregate(flat: torch.Tensor, weights: torch.Tensor,
                             lambda_: float, b: int, *,
                             path: Optional[WirePath] = None):
    """Encode U stacked deltas and reduce ``sum_g w_g * deq(wire_g)``
    from the packed buffers.

    Returns ``(agg [d], bits [U], aux)``; ``bits`` replays the paper's
    accounting ``d (b s + 1 - s) + 32`` in f32 in the JAX package's op
    order, so it is bit-exact wherever ``dbar`` is."""
    U, d = flat.shape
    wire = mixed_res_encode(flat, lambda_, b, path=path)
    agg = mixed_res_wire_reduce(wire, weights, b, d, path=path)
    inf = wire.head[:, H_INF]
    dw_q = wire.head[:, H_DWQ]
    dbar = wire.head[:, H_DBAR]
    s = true_div(dbar, d)
    bits = d * (b * s + 1.0 - s) + 32.0
    bits = torch.where(inf > 0, bits, float(d) + 32.0)
    aux = {"s": s, "dbar": dbar.to(torch.int32), "r": inf - dw_q,
           "dw_q": dw_q, "inf": inf}
    return agg, bits, aux


def flash_decode_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    length: Union[int, torch.Tensor]) -> torch.Tensor:
    """Single-token GQA decode attention.

    q: [B, H, D]; k/v: [B, S, Hkv, D(v)] (the KV cache's layout);
    length: int or one-int tensor — positions >= length are masked.
    Returns [B, H, Dv].  Head h reads kv head h // (H/Hkv).  The caches
    go to K6 as transposed views, so nothing is copied.  The JAX op's
    ``kv_block`` tile is not taken: K6 picks its own split of S."""
    B, H, D = q.shape
    Hkv = k.shape[2]
    if H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} kv heads")
    if k.dtype != q.dtype:          # the JAX path's ``ck.astype(dt)``
        k, v = k.to(q.dtype), v.to(q.dtype)
    qg = q.reshape(B, Hkv, H // Hkv, D).contiguous()
    out = flash_decode(qg, k.transpose(1, 2), v.transpose(1, 2), length)
    return out.reshape(B, H, -1)
