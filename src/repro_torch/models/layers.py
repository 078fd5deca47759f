"""Shared building blocks of the decoders: norms, RoPE, MLPs, init
helpers and the plain attention paths — the port of
``repro/models/layers.py``.

Conventions, as in the JAX package:

* params are nested dicts of tensors, stored float32;
* forward functions cast to the config's compute dtype at use, and
  ``rms_norm``, ``apply_rope`` and the attention softmax compute in
  float32 inside and return the input's dtype;
* all linears are bias-free.

``repro/models/sharding_ctx.shard`` is the identity outside a device
mesh, and the port runs on one card, so it is not ported and the calls
to it are left out.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import true_div


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               scale: float = 1.0, lead: Sequence[int] = ()) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut to [-2, 2], times
    ``scale / sqrt(d_in)``, shape ``lead + (d_in, d_out)`` in float32,
    on the generator's device.  ``lead`` stacks layers, as the JAX
    package's ``vmap`` over keys does.  torch's generator is not JAX's
    ``PRNGKey``: the numbers differ from the JAX package's at any seed
    (carry JAX's init with
    :func:`repro_torch.models.convert.params_from_jax` to compare)."""
    w = torch.empty((*lead, d_in, d_out), dtype=torch.float32,
                    device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(scale / math.sqrt(d_in))


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * weight.float()
    return out.to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    expo = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** expo)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)     # [hd/2]
    angles = positions[..., :, None].float() * freqs           # [...,S,hd/2]
    angles = angles[..., None, :]                              # [...,S,1,hd/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             lead: Sequence[int] = ()) -> dict:
    return {"w_gate": dense_init(generator, d_model, d_ff, lead=lead),
            "w_up": dense_init(generator, d_model, d_ff, lead=lead),
            "w_down": dense_init(generator, d_ff, d_model, lead=lead)}


def mlp_apply(params: dict, x: torch.Tensor, dtype) -> torch.Tensor:
    return swiglu(x, params["w_gate"].to(dtype), params["w_up"].to(dtype),
                  params["w_down"].to(dtype))


def causal_mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor,
                     window: int = 0) -> torch.Tensor:
    """Additive attention bias: 0 where k may attend, -inf otherwise.

    q_pos: [..., Sq], k_pos: [..., Sk] absolute positions.  window > 0
    enables sliding-window attention (k in (q - window, q])."""
    ok = k_pos[..., None, :] <= q_pos[..., :, None]
    if window > 0:
        ok &= k_pos[..., None, :] > (q_pos[..., :, None] - window)
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, -math.inf)


def expand_kv(k: torch.Tensor, H: int) -> torch.Tensor:
    """GQA kv-head expansion [B,S,Hkv,D] -> [B,S,H,D] (each kv head
    repeated H/Hkv times in place, as ``jnp.repeat``)."""
    Hkv = k.shape[2]
    if Hkv == H:
        return k
    return torch.repeat_interleave(k, H // Hkv, dim=2)


def softmax_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """q: [B,Sq,H,D], k/v: [B,Sk,Hkv,D(v)], bias: [B?,Sq,Sk] additive.

    Plain (non-chunked) attention in float32, kv heads expanded to H."""
    B, Sq, H, D = q.shape
    kf = expand_kv(k, H).float()
    vf = expand_kv(v, H).float()
    qf = true_div(q.float(), math.sqrt(D))
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    scores = scores + bias[:, None, :, :]
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, vf)
    return out.to(q.dtype)


def chunked_softmax_attend(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, q_pos: torch.Tensor,
                           k_pos: torch.Tensor, window: int = 0,
                           kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV chunks of ``kv_chunk`` (the
    JAX package's ``lax.scan`` is a Python loop here; nothing is
    differentiated, so there is no rematerialization).  Peak memory
    O(Sq * kv_chunk) instead of O(Sq * Sk)."""
    B, Sq, H, D = q.shape
    k = expand_kv(k, H)
    v = expand_kv(v, H)
    Sk, Dv = k.shape[1], v.shape[-1]
    n_chunks = -(-Sk // kv_chunk)
    pad = n_chunks * kv_chunk - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=2 ** 30)
    qf = true_div(q.float(), math.sqrt(D))
    m = torch.full((B, H, Sq), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, Dv), dtype=torch.float32, device=q.device)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        sl = slice(c * kv_chunk, (c + 1) * kv_chunk)
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, k[:, sl].float())
        bias = causal_mask_bias(q_pos, k_pos[:, sl], window)    # [B,Sq,Ck]
        scores = scores + bias[:, None, :, :]
        m_new = torch.maximum(m, torch.amax(scores, dim=-1))
        # guard fully-masked rows (all -inf) -> m_new may be -inf
        m_safe = torch.where(torch.isfinite(m_new), m_new, zero)
        p = torch.exp(scores - m_safe[..., None])
        p = torch.where(torch.isfinite(scores), p, zero)
        scale = torch.where(torch.isfinite(m), torch.exp(m - m_safe), zero)
        l = l * scale + torch.sum(p, dim=-1)
        acc = acc * scale[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, v[:, sl].float())
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]
