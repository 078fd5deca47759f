"""GQA self-attention with RoPE and optional qk-norm — the port of
``repro/models/attention.py``'s ``init_gqa``, ``gqa_apply`` and
``init_gqa_cache``.

The prefill/forward branch (no cache) is the plain attention, chunked
above :data:`CHUNKED_THRESHOLD` tokens, as in the JAX package.  The
decode branch writes the new k/v at ``cache_index`` and attends with
kernel K6 (``kernels.ops.flash_decode_op``) over the positions
``< cache_index + 1`` — the positions the JAX package's causal mask
keeps when it attends over the whole cache.

Unlike the JAX package, the decode branch updates the cache **in
place** (``index_copy_`` at the device-side ``cache_index``): a
functional update would copy every layer's cache on every token.
Sliding-window decode and cross-attention are not ported yet.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels.ops import flash_decode_op

from .config import ModelConfig
from .layers import (apply_rope, causal_mask_bias, chunked_softmax_attend,
                     dense_init, rms_norm, softmax_attend)

CHUNKED_THRESHOLD = 2048


def init_gqa(generator: torch.Generator, cfg: ModelConfig,
             lead: Sequence[int] = ()) -> dict:
    """Params on the generator's device (``lead`` stacks layers)."""
    d = cfg.d_model
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lead = tuple(lead)
    p = {"wq": dense_init(generator, d, H * Dh, lead=lead
                          ).reshape(*lead, d, H, Dh),
         "wk": dense_init(generator, d, Hkv * Dh, lead=lead
                          ).reshape(*lead, d, Hkv, Dh),
         "wv": dense_init(generator, d, Hkv * Dh, lead=lead
                          ).reshape(*lead, d, Hkv, Dh),
         "wo": dense_init(generator, H * Dh, d, lead=lead
                          ).reshape(*lead, H, Dh, d)}
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            p[name] = torch.ones((*lead, Dh), dtype=torch.float32,
                                 device=generator.device)
    return p


def gqa_apply(params: dict, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig, window: int = 0,
              cache: Optional[dict] = None,
              cache_index: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: [B, S, d].  Training/prefill when cache is None; decode
    (S == 1) writes the cache at cache_index in place and attends over
    its first cache_index + 1 positions with K6."""
    dt = x.dtype
    B, S, _ = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(dt))
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        if S > CHUNKED_THRESHOLD:
            out = chunked_softmax_attend(q, k, v, positions, positions,
                                         window=window)
        else:
            bias = causal_mask_bias(positions, positions, window)
            out = softmax_attend(q, k, v, bias)
        new_cache = None
    else:
        if window > 0:
            raise NotImplementedError(
                "sliding-window decode is not ported yet (K6 attends over "
                "all positions < cache_index + 1)")
        if S != 1:
            raise ValueError(f"decode takes one token per step, got S={S}")
        ck, cv = cache["k"], cache["v"]
        idx = cache_index.reshape(1).to(torch.long)
        ck.index_copy_(1, idx, k.to(ck.dtype))
        cv.index_copy_(1, idx, v.to(cv.dtype))
        length = (cache_index + 1).to(torch.int32)
        out = flash_decode_op(q[:, 0], ck, cv, length)[:, None]
        new_cache = cache
    out = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dt))
    return out, new_cache


def init_gqa_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   lead: Sequence[int] = (), device=None) -> dict:
    shape = (*lead, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
