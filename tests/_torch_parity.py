"""Card-versus-CPU comparison of one engine round, stage by stage (no
jax here: the GPU tests import it on a machine without jax)."""
import numpy as np
import torch

from repro_torch.core.quantize.base import unflatten_pytree
from repro_torch.kernels import ops


def card_vs_cpu_rounds(make, rounds: int):
    """Step one engine on the card and one on the CPU from identical
    params and minibatches, stage by stage.  ``make(device)`` builds the
    engine.  Per round, yields:

    * ``train_err``: max |card delta - CPU delta| over max |CPU delta|
      — cuDNN and the CPU sum the gradients in different orders, and
      AdaGrad's ``1/sqrt(G + 1e-8)`` magnifies that roundoff of
      near-zero gradients by up to ``alpha / 1e-4``;
    * ``card``, ``cpu``: ``(wire, agg, bits)`` of the wire path run on
      the SAME card deltas — through K1–K3 on the card and through the
      plain versions on the CPU — which must agree bit for bit.

    Both runs then take the card's update, so every round starts from
    identical params."""
    g, c = make("cuda"), make("cpu")
    gs, cs = g.start_run(), c.start_run()
    q = g.quantizer
    for _ in range(rounds):
        xg, yg = g.draw_minibatches(gs)
        xc, yc = c.draw_minibatches(cs)
        with torch.no_grad():
            fg = g._batched_local(gs.params, xg, yg)
            fc = c._batched_local(cs.params, xc, yc)
            train_err = float((fg.cpu() - fc).abs().max() / fc.abs().max())
            runs = []
            for flat, w in ((fg, g._weights), (fg.cpu(), c._weights)):
                wire = ops.mixed_res_encode(flat, q.lambda_, q.b)
                agg, bits, _ = ops.mixed_res_wire_aggregate(
                    flat, w, q.lambda_, q.b)
                runs.append((wire, agg, bits))
            upd = unflatten_pytree(runs[0][1], g.spec)
            gs.params = {k: gs.params[k] + upd[k] for k in gs.params}
            cs.params = {k: v.cpu() for k, v in gs.params.items()}
        yield train_err, runs[0], runs[1]


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
