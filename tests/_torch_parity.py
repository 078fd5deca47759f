"""Card-versus-CPU comparison of one engine round, stage by stage (no
jax here: the GPU tests import it on a machine without jax)."""
import numpy as np
import torch

from repro_torch.core.quantize.base import unflatten_pytree
from repro_torch.kernels import ops


def wire_of(eng, flat):
    """What the engine's plane computes on the way to its aggregate for
    the deltas ``flat`` — the buffers that must agree bit for bit
    between the card and the CPU: the four packed buffers (K1, K2); or
    the batched recons, the sign words (K4) and the sign-plane sum
    (K5); or the batched recons alone (dense)."""
    q, w, plane = eng.quantizer, eng._weights, eng.wire_path_spec.plane
    if plane == "packed":
        return tuple(ops.mixed_res_encode(flat, q.lambda_, q.b))
    res, _ = q.batched(flat)
    if plane == "dense":
        return (res.recon,)
    words = ops.signpack_op(ops.wire_view(flat).reshape(-1))
    low = ops.packed_sign_weighted_sum(flat, w * res.aux["dw_q"] * 0.5)
    return res.recon, words, low


def card_vs_cpu_rounds(make, rounds: int):
    """Step one engine on the card and one on the CPU from identical
    params and minibatches, stage by stage.  ``make(device)`` builds the
    engine.  Per round, yields:

    * ``train_err``: max |card delta - CPU delta| over max |CPU delta|
      — cuDNN and the CPU sum the gradients in different orders, and
      AdaGrad's ``1/sqrt(G + 1e-8)`` magnifies that roundoff of
      near-zero gradients by up to ``alpha / 1e-4``;
    * ``card``, ``cpu``: ``(wire, agg, bits, flat)`` of the engine's
      plane run on the SAME card deltas ``flat`` — through the kernels
      on the card and the plain versions on the CPU (:func:`wire_of`
      for ``wire``).  ``wire`` and ``bits`` must agree bit for bit, and
      so must the packed plane's ``agg``; the other planes' ``agg``
      ends in a weighted sum that cuBLAS and the CPU order differently.

    Both runs then take the card's update, so every round starts from
    identical params."""
    g, c = make("cuda"), make("cpu")
    gs, cs = g.start_run(), c.start_run()
    for _ in range(rounds):
        xg, yg = g.draw_minibatches(gs)
        xc, yc = c.draw_minibatches(cs)
        with torch.no_grad():
            fg = g._batched_local(gs.params, xg, yg)
            fc = c._batched_local(cs.params, xc, yc)
            train_err = float((fg.cpu() - fc).abs().max() / fc.abs().max())
            runs = []
            for eng, flat in ((g, fg), (c, fg.cpu())):
                agg, bits, _ = eng.aggregate(flat)
                runs.append((wire_of(eng, flat), agg, bits, flat))
            upd = unflatten_pytree(runs[0][1], g.spec)
            gs.params = {k: gs.params[k] + upd[k] for k in gs.params}
            cs.params = {k: v.cpu() for k, v in gs.params.items()}
        yield train_err, runs[0], runs[1]


def agg_tol(weights: torch.Tensor, flat: torch.Tensor) -> float:
    """``4 * G * eps32 * sum_g w_g * ||x_g||_inf``: how far two orders
    of the same weighted sum of G reconstructions may land apart."""
    w = weights.detach().double().abs().cpu()
    inf = flat.detach().double().abs().amax(dim=1).cpu()
    eps32 = float(np.finfo(np.float32).eps)
    return 4 * len(w) * eps32 * float((w * inf).sum())


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality of two tensors (moved to the CPU)."""
    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    if a.dtype != torch.int32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def assert_trajectory_close(got: dict, want: dict, flips: int,
                            rounds: int, L: int, alpha: float,
                            atol: float = 1e-4) -> None:
    """After ``rounds`` rounds each run from its own params: with no
    threshold flip on the way (``flips`` = summed per-user ``|dbar|``
    differences), every element within ``atol``.  A flip makes the
    later rounds train from different params, so then only AdaGrad's
    step bound holds (each element moves less than ``L * alpha`` a
    round in either run) and at most 0.1% of the elements may lie
    beyond ``atol``."""
    diff = np.concatenate([
        np.abs(np.asarray(got[k], np.float64)
               - np.asarray(want[k], np.float64)).ravel()
        for k in sorted(want)])
    if flips == 0:
        assert diff.max() <= atol, diff.max()
        return
    assert (diff > atol).mean() <= 1e-3, (diff > atol).mean()
    assert diff.max() <= 2 * rounds * L * alpha, diff.max()
