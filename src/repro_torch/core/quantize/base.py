"""Quantizer interface shared by the paper's scheme and the benchmarks.

A quantizer maps a local gradient (delta) vector ``delta`` to
``(recon, bits)`` where ``recon`` is the server-side reconstruction
and ``bits`` the number of bits the user transmits for that vector in
that round.  Tensors in, tensors out, on the caller's device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Tuple

import torch
from torch.func import vmap
from torch.utils._pytree import tree_map


@dataclasses.dataclass(frozen=True)
class QuantResult:
    """Outcome of quantizing one local delta vector."""

    recon: torch.Tensor     # dequantized vector, same shape as the input
    bits: torch.Tensor      # scalar — total payload bits for this vector
    aux: Dict[str, Any]     # scheme-specific diagnostics (s fraction, ...)


class Quantizer:
    """Stateless quantizer base.  Subclasses implement __call__.

    Stateful schemes thread their state explicitly:
    ``__call__(delta, state) -> (QuantResult, state)``.
    """

    name: str = "base"

    def init_state(self, dim: int) -> Any:
        """Per-user state (None for stateless schemes)."""
        return None

    def __call__(self, delta: torch.Tensor, state: Any = None
                 ) -> Tuple[QuantResult, Any]:
        raise NotImplementedError

    # ------------------------------------------------ batched entry point
    def init_batched_state(self, K: int, dim: int, device=None) -> Any:
        """Stacked per-user state with a leading K axis on ``device``
        (None when stateless).  The default replicates init_state(dim)
        K times, each user in storage of its own (not K views of one),
        so no write to one user's state reaches another's."""
        state = self.init_state(dim)
        if state is None:
            return None
        return tree_map(lambda x: x.to(device or x.device)[None].repeat(
            (K,) + (1,) * x.dim()), state)

    def batched(self, deltas: torch.Tensor, states: Any = None
                ) -> Tuple[QuantResult, Any]:
        """Quantize K stacked delta vectors in one vmapped call.

        ``deltas``: [K, d]; ``states``: output of init_batched_state (or
        None).  Returns a QuantResult with leading-K fields plus the
        updated stacked state.  Each row is reduced on its own, so the
        results match __call__ row for row bit for bit."""
        def one(x, s):
            res, new = self(x, s)
            return (res.recon, res.bits, res.aux), new

        if states is None:
            recon, bits, aux = vmap(lambda x: one(x, None)[0])(deltas)
            new_states = None
        else:
            (recon, bits, aux), new_states = vmap(one)(deltas, states)
        return QuantResult(recon=recon, bits=bits, aux=aux), new_states


def _leaves(tree) -> List[torch.Tensor]:
    """Leaves in ``jax.tree_util.tree_flatten``'s order: dict entries
    by sorted key, lists and tuples in sequence."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in _leaves(v)]
    return [tree]


def _skeleton(tree):
    """The nest's structure with every leaf replaced by None."""
    if isinstance(tree, dict):
        return {k: _skeleton(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_skeleton(v) for v in tree)
    return None


def _rebuild(skel, leaves: Iterator):
    if isinstance(skel, dict):
        return {k: _rebuild(v, leaves) for k, v in skel.items()}
    if isinstance(skel, (list, tuple)):
        return type(skel)(_rebuild(v, leaves) for v in skel)
    return next(leaves)


def flatten_pytree(tree) -> Tuple[torch.Tensor, Any]:
    """Flatten a nest of tensors into one 1-D f32 vector + spec.

    The leaf order is JAX's (sorted dict keys), so the flat vector is
    the same vector ``repro.core.quantize.flatten_pytree`` builds from
    the same parameters.  The spec records each leaf's dtype so
    :func:`unflatten_pytree` casts back."""
    leaves = _leaves(tree)
    shapes = [tuple(l.shape) for l in leaves]
    sizes = [int(l.numel()) for l in leaves]
    dtypes = [l.dtype for l in leaves]
    flat = torch.cat([l.reshape(-1).to(torch.float32) for l in leaves])
    return flat, (_skeleton(tree), shapes, sizes, dtypes)


def unflatten_pytree(flat: torch.Tensor, spec) -> Any:
    """Inverse of :func:`flatten_pytree` (views into ``flat`` where the
    dtype already matches)."""
    skel, shapes, sizes, dtypes = spec
    leaves, offset = [], 0
    for shape, size, dtype in zip(shapes, sizes, dtypes):
        leaves.append(flat[offset:offset + size].reshape(shape).to(dtype))
        offset += size
    return _rebuild(skel, iter(leaves))
