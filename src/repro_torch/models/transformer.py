"""Model assembly for the dense GQA decoders — the port of
``repro/models/transformer.py`` for block kind ``"A"`` with GQA
attention and a dense SwiGLU MLP (granite-3-8b, minitron-8b,
qwen3-14b).

Params tree (the JAX package's keys, so carrying weights across is a
tree map — :mod:`repro_torch.models.convert`):

    embed            [V_padded, d]
    blocks           {"A": per-layer params stacked on a leading axis}
    final_norm       [d]
    lm_head          [d, V_padded] (absent when tied)

The JAX package scans over the stacked layers; here a Python loop
takes layer ``i``'s views.  ``forward`` has no rematerialization
(nothing is trained here).  ``decode_step`` updates the cache in place
and returns it.  Block kinds ``M``/``R``/``S``, MLA, MoE,
encoder-decoder and vision front ends raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.device import resolve_device

from .attention import gqa_apply, init_gqa, init_gqa_cache
from .config import ModelConfig
from .layers import (dense_init, init_mlp, mlp_apply, rms_norm, tree_leaves,
                     tree_map)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(dtype) -> torch.dtype:
    """A config's dtype name (or a torch dtype) as a torch dtype."""
    return dtype if isinstance(dtype, torch.dtype) else _DTYPES[str(dtype)]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port cannot run yet."""
    missing = []
    if cfg.attn_type != "gqa":
        missing.append(f"attn_type={cfg.attn_type!r}")
    if cfg.num_experts:
        missing.append("MoE FFN")
    if set(cfg.block_pattern) != {"A"}:
        missing.append(f"block pattern {cfg.block_pattern!r}")
    if cfg.is_encoder_decoder:
        missing.append("encoder-decoder")
    if cfg.frontend != "none":
        missing.append(f"frontend={cfg.frontend!r}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported to repro_torch yet: "
            f"{', '.join(missing)} (the port runs dense GQA decoders)")


# ---------------------------------------------------------------- blocks
def init_block(generator: torch.Generator, cfg: ModelConfig, kind: str,
               lead: Sequence[int] = ()) -> dict:
    """One block's params on the generator's device (``lead`` stacks
    layers)."""
    if kind in ("M", "R", "S"):
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    if kind != "A":
        raise ValueError(f"unknown block kind {kind!r}")
    check_supported(cfg)
    d, lead, dev = cfg.d_model, tuple(lead), generator.device
    return {"norm1": torch.ones((*lead, d), dtype=torch.float32, device=dev),
            "norm2": torch.ones((*lead, d), dtype=torch.float32, device=dev),
            "attn": init_gqa(generator, cfg, lead=lead),
            "mlp": init_mlp(generator, d, cfg.d_ff, lead=lead)}


def block_apply(kind: str, params: dict, x: torch.Tensor,
                positions: torch.Tensor, cfg: ModelConfig, window: int = 0,
                cache: Optional[dict] = None,
                cache_index: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[dict], float]:
    """Returns (x, new_cache, aux_loss); a dense block's aux loss is 0."""
    if kind != "A":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    a, new_attn_cache = gqa_apply(params["attn"], h, positions, cfg, window,
                                  cache and cache["attn"], cache_index)
    x = x + a
    h = rms_norm(x, params["norm2"], cfg.norm_eps)
    x = x + mlp_apply(params["mlp"], h, x.dtype)
    new_cache = None if cache is None else {"attn": new_attn_cache}
    return x, new_cache, 0.0


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype, lead: Sequence[int] = (), device=None) -> dict:
    if kind != "A":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    return {"attn": init_gqa_cache(cfg, batch, max_len, torch_dtype(dtype),
                                   lead=lead, device=device)}


# ---------------------------------------------------------------- pattern
def pattern_runs(pattern: str):
    """Contiguous runs: [(kind, start_within_kind, length), ...]."""
    runs, counts = [], {}
    i = 0
    while i < len(pattern):
        k = pattern[i]
        j = i
        while j < len(pattern) and pattern[j] == k:
            j += 1
        runs.append((k, counts.get(k, 0), j - i))
        counts[k] = counts.get(k, 0) + (j - i)
        i = j
    return runs


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of stacked params or caches, as views."""
    return tree_map(lambda t: t[i], tree)


# ---------------------------------------------------------------- model
def init_model(generator: torch.Generator, cfg: ModelConfig,
               device=None) -> Dict[str, Any]:
    """Random float32 params from ``generator``, made on ``device``
    (the card unless the caller asks for the CPU), where the generator
    must live.  The numbers differ from the JAX package's at any seed;
    carry JAX's init with ``convert.params_from_jax``."""
    check_supported(cfg)
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"the generator is on {generator.device}, the "
                         f"params go to {dev}")
    d = cfg.d_model
    params: Dict[str, Any] = {
        "embed": dense_init(generator, cfg.vocab_padded, d, scale=1.0),
        "final_norm": torch.ones((d,), dtype=torch.float32,
                                 device=generator.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, d, cfg.vocab_padded)
    params["blocks"] = {"A": init_block(generator, cfg, "A",
                                        lead=(cfg.num_layers,))}
    return params


def embed_inputs(params: dict, batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token embedding.  Returns (h [B,S,d], loss_mask [B,S])."""
    if cfg.frontend != "none":
        raise NotImplementedError(f"frontend {cfg.frontend!r} is not "
                                  "ported yet")
    tok = batch["tokens"]
    h = params["embed"][tok].to(torch_dtype(cfg.dtype))
    mask = torch.ones(tok.shape, dtype=torch.float32, device=tok.device)
    return h, mask


def _lm_head(params: dict, h: torch.Tensor, cfg: ModelConfig
             ) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    head = params.get("lm_head", None)
    if head is None:
        head = params["embed"].T
    return h @ head.to(h.dtype)


def forward(params: dict, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            window: int = 0
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill forward over ``batch["tokens"]`` [B, S].  Returns
    (logits [B, S, V_padded], loss_mask, aux)."""
    check_supported(cfg)
    h, mask = embed_inputs(params, batch, cfg)
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device)[None].expand(B, S)
    for kind, off, n in pattern_runs(cfg.block_pattern):
        for i in range(off, off + n):
            h, _, _ = block_apply(kind, _layer(params["blocks"][kind], i),
                                  h, positions, cfg, window)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)  # no MoE
    return _lm_head(params, h, cfg), mask, aux


# ---------------------------------------------------------------- decode
def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               window: int = 0, device=None) -> dict:
    """Static-shape cache stacks, one entry per block kind, zeroed, on
    ``device`` (the card unless the caller asks for the CPU)."""
    check_supported(cfg)
    dev = resolve_device(device)
    attn_len = min(max_len, window) if window else max_len
    counts = cfg.counts()
    return {kind: init_block_cache(cfg, kind, batch, attn_len, dtype,
                                   lead=(counts[kind],), device=dev)
            for kind in "AMRS" if counts.get(kind, 0)}


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                cache_index: torch.Tensor, cfg: ModelConfig,
                window: int = 0) -> Tuple[torch.Tensor, dict]:
    """One decode step.  tokens: [B, 1]; cache_index: int tensor of one
    value on the params' device (the next write position).  Each
    attention layer writes its k/v there, in place, and attends with K6
    over positions < cache_index + 1.  Returns (logits [B, 1,
    V_padded], cache) — the same cache object, updated."""
    check_supported(cfg)
    dt = torch_dtype(cfg.dtype)
    B = tokens.shape[0]
    h = params["embed"][tokens].to(dt)
    positions = cache_index.reshape(1, 1).expand(B, 1)
    for kind, off, n in pattern_runs(cfg.block_pattern):
        for i in range(off, off + n):
            h, _, _ = block_apply(kind, _layer(params["blocks"][kind], i), h,
                                  positions, cfg, window,
                                  cache=_layer(cache[kind], i),
                                  cache_index=cache_index)
    return _lm_head(params, h, cfg), cache


def param_count(params) -> int:
    return sum(int(t.numel()) for t in tree_leaves(params))
