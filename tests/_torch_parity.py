"""Card-versus-CPU comparison of one engine round, stage by stage, and
of the baseline quantizers, with the baselines' payload rules; two runs
compared bit for bit; churn rounds with their launches of K1–K5
held against the plain versions (no jax here: the GPU tests and
``chip_smoke.py`` import it on a machine without jax)."""
import math
import time

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
                agg, bits, _, _ = eng.aggregate(flat)
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


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality of two tensors of any dtype (moved to the
    CPU): floats compare by their bit patterns, so -0.0 != 0.0 and a
    NaN equals the same NaN."""
    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = a.view(ints[a.element_size()]), b.view(ints[b.element_size()])
    return torch.equal(a, b)


def baseline_card_vs_cpu(make, flats):
    """One baseline quantizer's ``batched`` on the card against the same
    call on the CPU, on the card deltas ``flats`` (a list of ``[K, d]``
    tensors); ``make()`` builds the quantizer.  Raises AssertionError on
    any disagreement; returns what was found.

    * classic, top-q: recon, bits and aux bit for bit on ``flats[0]``;
    * AQUILA: the same ``b_selected`` except where a candidate's error
      lies within 1e-6 of ``tol``; where ``b`` agrees, recon and bits
      bit for bit;
    * LAQ: one call per element of ``flats``, both sides from the card's
      state (the CPU's is resynced after each call).  recon and bits bit
      for bit wherever the skip decisions agree; a decision may differ
      only where ``|energy - xi * hist| <= 1e-5 * hist``."""
    from repro_torch.core.quantize.laq import _uniform_quantize

    qc, qp = make(), make()
    K, d = flats[0].shape
    found = {"flips": 0}
    if qc.name != "laq":
        rc, _ = qc.batched(flats[0])
        rp, _ = qp.batched(flats[0].cpu())
        same = torch.ones(K, dtype=torch.bool)
        if qc.name == "aquila":
            bc, bp = rc.aux["b_selected"].cpu(), rp.aux["b_selected"]
            same = bc == bp
            for k in torch.nonzero(~same).flatten().tolist():
                x = flats[0][k].cpu()
                c = _uniform_quantize(x, int(min(bc[k], bp[k])))
                err = float((c - x).double().norm() / x.double().norm())
                tol = float(np.float32(qc.tol))
                assert abs(err - tol) <= 1e-6, (k, err, tol)
            found["flips"] = int((~same).sum())
            found["b_selected"] = bc.tolist()
        for k in torch.nonzero(same).flatten().tolist():
            assert same_bits(rc.recon[k], rp.recon[k]), (qc.name, k)
            assert same_bits(rc.bits[k], rp.bits[k]), (qc.name, k)
        if qc.name != "aquila":
            for key in rp.aux:
                assert same_bits(rc.aux[key], rp.aux[key]), (qc.name, key)
        return found
    sc = qc.init_batched_state(K, d, device=flats[0].device)
    energy_rel, skips = 0.0, 0
    for flat in flats:
        hist = sc.energies.double().mean(dim=1).cpu()
        sp = type(sc)(*(s.cpu() for s in sc))
        rc, sc = qc.batched(flat, sc)
        rp, sp = qp.batched(flat.cpu(), sp)
        kc, kp = rc.aux["skipped"].cpu(), rp.aux["skipped"]
        energy = rc.aux["energy"].double().cpu()
        for k in torch.nonzero(kc != kp).flatten().tolist():
            assert abs(energy[k] - qc.xi * hist[k]) <= 1e-5 * hist[k], k
        found["flips"] += int((kc != kp).sum())
        skips += int(kc.sum())
        for k in torch.nonzero(kc == kp).flatten().tolist():
            assert same_bits(rc.recon[k], rp.recon[k]), ("laq", k)
            assert same_bits(rc.bits[k], rp.bits[k]), ("laq", k)
            assert same_bits(sc.last_sent[k], sp.last_sent[k]), ("laq", k)
            assert same_bits(sc.ptr[k], sp.ptr[k]), ("laq", k)
        rel = (sc.energies.double().cpu() - sp.energies.double()).abs() \
            / sp.energies.double().abs().clamp_min(1e-300)
        energy_rel = max(energy_rel, float(rel.max()))
    found.update(skips=skips, energy_rel=energy_rel)
    return found


def payload_rule(qlabel: str, d: int):
    """``(text, check)``: the payload each user's bits must equal at
    dimension ``d`` under the Table III settings of quantizer
    ``qlabel`` (top-q q = 0.01, LAQ b = 4, AQUILA b in [2, 8],
    mixed-resolution b = 4); ``check`` maps a ``[K]`` array of one
    round's bits to a boolean mask."""
    k = math.ceil(0.01 * d)
    topq = k * (32.0 + math.ceil(math.log2(d)))
    rules = {
        "classic": (f"32d = {32.0 * d:.0f}", lambda x: x == 32.0 * d),
        "top-q": (f"k(32 + ceil(log2 d)) = {topq:.0f} (k = {k})",
                  lambda x: x == topq),
        "laq": (f"0 or 4d + 32 = {4.0 * d + 32:.0f}",
                lambda x: (x == 0.0) | (x == 4.0 * d + 32.0)),
        "aquila": ("d b + 32, b in [2, 8]", lambda x: np.isin(
            x, [d * b + 32.0 for b in range(2, 9)])),
        "mixed-resolution": (f"in [d + 32, 4d + 32] = [{d + 32}, "
                             f"{4 * d + 32}]",
                             lambda x: (x >= d + 32.0) & (x <= 4.0 * d + 32)),
    }
    return rules[qlabel]


def run_mismatches(got, want) -> list:
    """Where two ``FLResult`` runs differ: each round's bits, uplink,
    cumulative latency, mean s and accuracy compared exactly, the
    params bit for bit.  Empty when one run is the other bit for bit."""
    bad = []
    if len(got.logs) != len(want.logs):
        bad.append(("rounds", len(got.logs), len(want.logs)))
    for g, w in zip(got.logs, want.logs):
        if not np.array_equal(g.bits_per_user, w.bits_per_user):
            bad.append((g.round, "bits"))
        for field in ("uplink_latency_s", "cum_latency_s", "mean_s",
                      "test_acc"):
            if getattr(g, field) != getattr(w, field):
                bad.append((g.round, field, getattr(g, field),
                            getattr(w, field)))
    for k in sorted(want.params):
        if not same_bits(got.params[k], want.params[k]):
            bad.append(("params", k))
    return bad


class WireSpy:
    """Records each call ``kernels.ops`` makes to the K1
    (``mixed_res_reduce``), K2 (``mixed_res_emit``), K3
    (``mixed_res_dequant_reduce``), K4 (``signpack``) and K5
    (``sign_dequant_reduce``) wrappers, inputs and output, so the
    launches of a run can be held afterwards against the plain versions
    on the very same inputs.  The wrappers still count their launches;
    the plain versions launch nothing.  CPU tensors never reach the
    wrappers (``ops`` calls the plain versions there), so a CPU run
    records nothing."""

    PLAIN = {"mixed_res_reduce": "mixed_res_reduce_ref",
             "mixed_res_emit": "mixed_res_emit_ref",
             "mixed_res_dequant_reduce": "mixed_res_dequant_reduce_ref",
             "signpack": "signpack_ref",
             "sign_dequant_reduce": "sign_dequant_reduce_ref"}
    # the argument holding the per-user weights (K3) or scales (K5)
    WEIGHTS = {"mixed_res_dequant_reduce": 4, "sign_dequant_reduce": 1}

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self.real = {n: getattr(ops, n) for n in self.PLAIN}
        for name, real in self.real.items():
            def spy(*args, _name=name, _real=real, **kw):
                out = _real(*args, **kw)
                self.calls.append((_name, args, kw, out))
                return out
            setattr(ops, name, spy)
        return self

    def __exit__(self, *exc):
        for name, real in self.real.items():
            setattr(ops, name, real)

    def check(self, absent: np.ndarray) -> dict:
        """Each recorded call against its plain version bit for bit
        (every output buffer); the weights (K3) or scales (K5) of the
        ``absent`` users must be exactly 0.  Returns the calls checked
        by kernel, then forgets them."""
        from repro_torch.kernels import ref

        found = {}
        idx = torch.as_tensor(np.flatnonzero(absent))
        for name, args, kw, out in self.calls:
            want = getattr(ref, self.PLAIN[name])(*args, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            wants = want if isinstance(want, tuple) else (want,)
            assert len(outs) == len(wants) and all(
                same_bits(o, w) for o, w in zip(outs, wants)), \
                f"{name} differs from its plain version on the same inputs"
            if name in self.WEIGHTS:
                w = args[self.WEIGHTS[name]].detach().cpu()
                assert len(w) == len(absent), (name, len(w))
                assert bool((w[idx] == 0).all()), (name, w[idx])
            found[name] = found.get(name, 0) + 1
        self.calls.clear()
        return found


def churn_rounds(eng, rounds: int):
    """``rounds`` rounds of a churn engine through its round-stepping
    API (train, sub-channel power solve, finish).  Each round, bit for
    bit: every K1–K5 launch against its plain version on the same
    inputs, absent users' weights and scales 0 (:class:`WireSpy`); a
    stateful quantizer's absent users' state unchanged by the round;
    absent users' bits and latencies 0.  Yields ``(work, log, info)``
    a round, ``info`` holding the round's ``wall`` seconds (train to
    finish, closed by a synchronize on the card), the ``calls`` checked
    and the ``active`` count."""
    from torch.utils._pytree import tree_leaves, tree_map

    cuda = eng.device.type == "cuda"
    state = eng.start_run()
    for t in range(1, rounds + 1):
        before = None if state.qstate is None \
            else tree_map(torch.clone, state.qstate)
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with WireSpy() as spy:
            work = eng.train_round(state, t)
        uplink, per_user = eng.solve_uplink_host(state.chan, work.bits_np,
                                                 work.active)
        eng.finish_round(state, work, uplink, per_user_s=per_user)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        absent = work.active == 0
        calls = spy.check(absent)
        assert np.all(work.bits_np[absent] == 0.0), work.bits_np
        assert np.all(per_user[absent] == 0.0), per_user
        if before is not None:
            gone = torch.as_tensor(np.flatnonzero(absent),
                                   device=eng.device)
            for old, new in zip(tree_leaves(before),
                                tree_leaves(state.qstate)):
                assert same_bits(new.index_select(0, gone),
                                 old.index_select(0, gone)), \
                    "an absent user's quantizer state changed"
        yield work, state.logs[-1], dict(wall=wall, calls=calls,
                                         active=int(work.active.sum()))


def fold_chunks(x: torch.Tensor, weights: torch.Tensor, lambda_: float,
                b: int, C: int, path=None):
    """The cohort fold on given deltas ``x`` [U, d]: chunks of C users
    encoded (K1, the epilogue, K2) and folded one after another into the
    carried accumulator (K3 with ``acc``, the first chunk without), as
    the engine's cohort step folds its cohorts.  Returns ``(acc [d],
    head [U, 8])``, to hold against the one-shot
    ``mixed_res_encode`` + ``mixed_res_wire_reduce`` of all U users:
    the same values (+0.0 and -0.0 alike) and the same headers."""
    U, d = x.shape
    acc, heads = None, []
    for c0 in range(0, U, C):
        wire = ops.mixed_res_encode(x[c0:c0 + C], lambda_, b, path=path)
        acc = ops.mixed_res_wire_reduce(wire, weights[c0:c0 + C], b, d,
                                        acc=acc, path=path)
        heads.append(wire.head)
    return acc, torch.cat(heads)


def params_gap(a: dict, b: dict) -> float:
    """max |a - b| over every leaf of two params dicts (on the host)."""
    return max(float((a[k].detach().double().cpu()
                      - b[k].detach().double().cpu()).abs().max())
               for k in a)


def segment_bits_identity(bits: torch.Tensor, seg_bits: torch.Tensor,
                          heads, segments) -> None:
    """Per-layer budget accounting: each segment's payload is the
    mixed-resolution payload of that segment alone,
    ``d_seg (b_seg s_seg + 1 - s_seg) + 32`` in f32 from its header
    (``heads``: the segments' [U, 8] headers in order), and ``bits`` is
    their sum, left to right in f32 and within four f32 roundings a
    segment of the exact float64 sum."""
    want = None
    exact = np.zeros(bits.shape[0])
    for i, (seg, head) in enumerate(zip(segments, heads)):
        sb, _ = ops.wire_head_stats(head, seg.b, seg.size)
        assert same_bits(seg_bits[:, i], sb), (seg, i)
        want = sb if want is None else want + sb
        dbar = head[:, ops.H_DBAR].double().cpu().numpy()
        inf = head[:, ops.H_INF].double().cpu().numpy()
        s = dbar / seg.size
        exact += np.where(inf > 0, seg.size * (seg.b * s + 1 - s),
                          seg.size) + 32.0
    assert same_bits(bits, want)
    ulp = np.spacing(np.float32(exact.max()))
    gap = np.abs(bits.double().cpu().numpy() - exact).max()
    assert gap <= 4 * len(segments) * float(ulp), (gap, ulp)
