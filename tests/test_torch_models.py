"""Parity of the port's dense GQA decoders and serve loop with the JAX
package, on the CPU, where every attention layer's decode step runs the
plain version of K6.

Weights are the JAX package's init, carried across with
``params_from_jax``; tokens are made with numpy from a seed.  Stated
tolerances:

* configs: field for field;
* ``layers.*`` at float32: rtol 1e-5, atol 1e-6 (another summation
  order; ``sin``/``cos``/``pow`` of another library);
* ``forward`` and 8 ``decode_step``s of the reduced granite-3-8b and
  qwen3-14b (and granite regrouped to 2 kv heads, G = 2): at float32,
  logits within 1e-5 of max|logit| and caches within 1e-5 of max|cache|;
  at the configs' bfloat16, within 5e-2 of the max — torch rounds every
  bfloat16 op's result while XLA on the CPU keeps fused elementwise
  chains in float32, so activations drift by a few bfloat16 ulps;
* the port's decode against its own forward, as the JAX package's
  ``test_decode_matches_forward``: 1e-4 of the max at float32, its
  0.15 at bfloat16;
* the serve loop: the JAX example's greedy token ids, exactly, at
  float32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.models import config as jconfig
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_model as jinit_model
from repro.models import layers as jl
from repro.models import param_count as jparam_count
from repro_torch.configs import ARCH_IDS, UNPORTED_ARCH_IDS, get_config
from repro_torch.models import (INPUT_SHAPES, ModelConfig, decode_step,
                                forward, init_cache, init_model, param_count,
                                params_from_jax, params_to_jax)
from repro_torch.models import layers as tl
from repro_torch.models.layers import tree_map
from repro_torch.models.transformer import init_block
from repro_torch.serve import cast_params, greedy_generate

F32 = dict(rtol=1e-5, atol=1e-6)

# arch id and the kv heads of its reduced variant (None: as reduced())
MODELS = [("granite-3-8b", None), ("qwen3-14b", None), ("granite-3-8b", 2)]


def configs(arch, kv=None, dtype=None):
    """The JAX and the port's reduced config of ``arch``."""
    out = []
    for get in (jget_config, get_config):
        cfg = get(arch).reduced()
        if kv:
            cfg = dataclasses.replace(cfg, num_kv_heads=kv)
        if dtype:
            cfg = dataclasses.replace(cfg, dtype=dtype)
        out.append(cfg)
    return out


def carried(cfg_j, seed=0):
    """JAX init of ``cfg_j`` and the same params in the port."""
    pj = jinit_model(jax.random.PRNGKey(seed), cfg_j)
    return pj, params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                               device="cpu")


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def rel_err(got, want):
    return float(np.max(np.abs(f32(got) - f32(want)))
                 / np.max(np.abs(f32(want))))


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_jax(arch):
    for full in (False, True):
        want, got = (c if full else c.reduced()
                     for c in (jget_config(arch), get_config(arch)))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.vocab_padded == want.vocab_padded
        assert got.counts() == want.counts()
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfig.INPUT_SHAPES.items()}


@pytest.mark.parametrize("arch", UNPORTED_ARCH_IDS)
def test_registry_names_unported_archs(arch):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        get_config(arch)


def test_registry_covers_the_jax_registry():
    assert sorted(ARCH_IDS + UNPORTED_ARCH_IDS) == sorted(JARCH_IDS)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("llama-7b")


def test_post_init_rules_kept():
    cfg = ModelConfig(name="x", family="dense", num_layers=3, d_model=64,
                      d_ff=128, vocab_size=300, num_heads=4, num_kv_heads=2)
    assert cfg.head_dim == 16 and cfg.block_pattern == "AAA"
    assert cfg.vocab_padded == 512
    with pytest.raises(ValueError, match="block_pattern"):
        ModelConfig(name="x", family="dense", num_layers=2, d_model=64,
                    d_ff=128, vocab_size=300, block_pattern="A")


# -------------------------------------------------------------- layers
def test_rms_norm_and_rope_freqs():
    x, w = rand(0, 2, 5, 64), rand(1, 64)
    np.testing.assert_allclose(
        f32(tl.rms_norm(torch.tensor(x), torch.tensor(w), 1e-5)),
        f32(jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)), **F32)
    for theta in (1e4, 1e6):
        np.testing.assert_allclose(f32(tl.rope_freqs(64, theta)),
                                   f32(jl.rope_freqs(64, theta)), **F32)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope(theta):
    x = rand(2, 2, 7, 4, 64)
    pos = np.random.default_rng(3).integers(0, 4096, (2, 7))
    got = tl.apply_rope(torch.tensor(x), torch.tensor(pos), theta)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), theta)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=2e-6)


def test_mlp_apply():
    x = rand(4, 2, 3, 32)
    pj = jl.init_mlp(jax.random.PRNGKey(0), 32, 48)
    pt = params_from_jax(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    np.testing.assert_allclose(
        f32(tl.mlp_apply(pt, torch.tensor(x), torch.float32)),
        f32(jl.mlp_apply(pj, jnp.asarray(x), jnp.float32)), **F32)


@pytest.mark.parametrize("window", [0, 3])
def test_causal_mask_bias(window):
    qp = np.array([[0, 4, 9]])
    kp = np.arange(12)[None]
    got = tl.causal_mask_bias(torch.tensor(qp), torch.tensor(kp), window)
    want = jl.causal_mask_bias(jnp.asarray(qp), jnp.asarray(kp), window)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(f32(got), f32(want))


def test_expand_kv():
    k = rand(5, 2, 3, 2, 8)
    np.testing.assert_array_equal(
        f32(tl.expand_kv(torch.tensor(k), 6)),
        f32(jl.expand_kv(jnp.asarray(k), 6)))


@pytest.mark.parametrize("window", [0, 5])
def test_softmax_and_chunked_attend(window):
    """Plain attention, and the chunked path over 4 chunks of 16 with a
    ragged last chunk (S = 50), both against JAX."""
    B, S, H, Hkv, D = 2, 50, 4, 2, 32
    q, k, v = rand(6, B, S, H, D), rand(7, B, S, Hkv, D), rand(8, B, S, Hkv, D)
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    tq, tk, tv, tp = map(torch.tensor, (q, k, v, pos.copy()))
    jq, jk, jv, jp = map(jnp.asarray, (q, k, v, pos))
    bias_t = tl.causal_mask_bias(tp, tp, window)
    bias_j = jl.causal_mask_bias(jp, jp, window)
    plain = tl.softmax_attend(tq, tk, tv, bias_t)
    np.testing.assert_allclose(f32(plain),
                               f32(jl.softmax_attend(jq, jk, jv, bias_j)),
                               **F32)
    got = tl.chunked_softmax_attend(tq, tk, tv, tp, tp, window, kv_chunk=16)
    want = jl.chunked_softmax_attend(jq, jk, jv, jp, jp, window, kv_chunk=16)
    np.testing.assert_allclose(f32(got), f32(want), **F32)
    np.testing.assert_allclose(f32(got), f32(plain), **F32)


def test_dense_init_is_a_truncated_fan_in_normal():
    g = torch.Generator().manual_seed(0)
    w = tl.dense_init(g, 400, 300, scale=2.0, lead=(3,))
    std = 2.0 / 20.0
    assert tuple(w.shape) == (3, 400, 300) and w.dtype == torch.float32
    assert float(w.abs().max()) <= 2 * std
    # N(0,1) cut to [-2, 2] has std 0.8796
    assert abs(float(w.std()) / std - 0.8796) < 0.01


# --------------------------------------------------------------- model
@pytest.mark.parametrize("arch,kv", MODELS)
def test_init_model_tree_matches_jax(arch, kv):
    cfg_j, cfg_t = configs(arch, kv)
    pj = jinit_model(jax.random.PRNGKey(0), cfg_j)
    pt = init_model(torch.Generator().manual_seed(0), cfg_t, device="cpu")
    shapes_j = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), pj)
    shapes_t = tree_map(lambda t: (tuple(t.shape), "float32"
                                   if t.dtype == torch.float32 else "?"), pt)
    assert shapes_t == shapes_j
    assert param_count(pt) == jparam_count(pj)
    # carried across and back, the tree is the same numbers
    back = params_to_jax(params_from_jax(
        jax.tree_util.tree_map(np.asarray, pj), device="cpu"))
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           jax.tree_util.tree_map(np.asarray, pj))


def _decode_run(arch, kv, dtype, steps=8, B=2):
    """forward over ``steps`` tokens and ``steps`` decode steps in both
    packages from the same params; returns the logits and caches."""
    cfg_j, cfg_t = configs(arch, kv, dtype)
    pj, pt = carried(cfg_j)
    tokens = np.random.default_rng(1).integers(0, cfg_j.vocab_size,
                                               (B, steps))
    fj, _, _ = jforward(pj, {"tokens": jnp.asarray(tokens, jnp.int32)},
                        cfg_j, remat=False)
    ft, _, _ = forward(pt, {"tokens": torch.tensor(tokens)}, cfg_t)
    step_j = jax.jit(lambda p, c, t, i: jdecode_step(p, c, t, i, cfg_j))
    cj = jinit_cache(cfg_j, B, steps + 4, jnp.dtype(cfg_j.dtype))
    ct = init_cache(cfg_t, B, steps + 4, cfg_t.dtype, device="cpu")
    dj, dt = [], []
    for t in range(steps):
        lj, cj = step_j(pj, cj, jnp.asarray(tokens[:, t:t + 1], jnp.int32),
                        jnp.asarray(t, jnp.int32))
        lt, ct = decode_step(pt, ct, torch.tensor(tokens[:, t:t + 1]),
                             torch.tensor(t, dtype=torch.int32), cfg_t)
        dj.append(lj[:, 0])
        dt.append(lt[:, 0])
    return (fj, ft), (jnp.stack(dj, 1), torch.stack(dt, 1)), (cj, ct)


@pytest.mark.parametrize("dtype,bound", [("float32", 1e-5),
                                         ("bfloat16", 5e-2)])
@pytest.mark.parametrize("arch,kv", MODELS)
def test_forward_and_decode_match_jax(arch, kv, dtype, bound):
    (fj, ft), (dj, dt), (cj, ct) = _decode_run(arch, kv, dtype)
    assert ft.dtype == getattr(torch, dtype)
    assert tuple(ft.shape) == tuple(fj.shape)
    assert rel_err(ft, fj) <= bound
    assert rel_err(dt, dj) <= bound
    for name in ("k", "v"):
        got, want = ct["A"]["attn"][name], cj["A"]["attn"][name]
        assert got.dtype == getattr(torch, dtype)
        assert rel_err(got, want) <= bound
        # positions past the last written one stay zero in both
        assert not np.any(f32(got)[:, :, 8:]) and not np.any(f32(want)[:, :, 8:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["granite-3-8b", "qwen3-14b"])
def test_decode_matches_forward(arch, dtype):
    """Greedy decode logits == teacher-forced forward logits, in the
    port alone (as ``tests/test_arch_smoke.py:82``)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 8)))
    logits_tf, _, _ = forward(params, {"tokens": tokens}, cfg)
    cache = init_cache(cfg, 1, 8, cfg.dtype, device="cpu")
    outs = []
    for t in range(8):
        lg, cache = decode_step(params, cache, tokens[:, t:t + 1],
                                torch.tensor(t, dtype=torch.int32), cfg)
        outs.append(lg[:, 0])
    dec = torch.stack(outs, 1)
    if dtype == "float32":
        assert rel_err(dec, logits_tf) <= 1e-4
    else:
        np.testing.assert_allclose(f32(logits_tf), f32(dec), rtol=0.15,
                                   atol=0.15)


# --------------------------------------------------------------- serve
def _jax_serve(params, cfg, prompts, gen):
    """The loop of ``examples/serve_batched.py``."""
    B, P = prompts.shape
    max_len = P + gen
    cache = jinit_cache(cfg, B, max_len, jnp.dtype(cfg.dtype))
    step = jax.jit(lambda p, c, t, i: jdecode_step(p, c, t, i, cfg))
    for t in range(P):
        logits, cache = step(params, cache, prompts[:, t:t + 1],
                             jnp.asarray(t, jnp.int32))
    tok = jnp.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None]
    generated = [tok]
    for t in range(P, max_len - 1):
        logits, cache = step(params, cache, tok.astype(jnp.int32),
                             jnp.asarray(t, jnp.int32))
        tok = jnp.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None]
        generated.append(tok)
    return np.asarray(jnp.concatenate(generated, axis=1))


@pytest.mark.parametrize("arch,kv", MODELS[:2])
def test_serve_loop_gives_the_jax_examples_tokens(arch, kv):
    cfg_j, cfg_t = configs(arch, kv, "float32")
    pj, pt = carried(cfg_j)
    prompts = np.random.default_rng(0).integers(1, cfg_j.vocab_size, (3, 6))
    want = _jax_serve(pj, cfg_j, jnp.asarray(prompts, jnp.int32), 10)
    got = greedy_generate(pt, cfg_t, torch.tensor(prompts), 10)
    assert got.decode_steps == 9
    np.testing.assert_array_equal(got.tokens.numpy(), want)
    # a longer cache masks its extra positions: the same tokens
    longer = greedy_generate(pt, cfg_t, torch.tensor(prompts), 10,
                             max_len=40)
    np.testing.assert_array_equal(longer.tokens.numpy(), want)


def test_serve_cli_runs_on_the_cpu():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
        "serve_batched_torch.py"
    spec = importlib.util.spec_from_file_location("serve_cli", path)
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    res = cli.main(["--device", "cpu", "--reduced", "--batch", "2",
                    "--prompt-len", "4", "--gen", "3", "--max-len", "16"])
    assert tuple(res.tokens.shape) == (2, 3) and res.decode_steps == 2


def test_serve_loop_takes_cast_params():
    """The caller casts the float32 masters once; the loop refuses
    params in another dtype than the config's."""
    cfg = get_config("granite-3-8b").reduced()
    params = init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    prompts = torch.ones((1, 2), dtype=torch.long)
    with pytest.raises(ValueError, match="cast_params"):
        greedy_generate(params, cfg, prompts, 2)
    res = greedy_generate(cast_params(params, cfg.dtype), cfg, prompts, 2)
    assert tuple(res.tokens.shape) == (1, 2)


# ------------------------------------------------- what is not ported
def test_unported_paths_raise():
    cfg = get_config("granite-3-8b").reduced()
    g = torch.Generator().manual_seed(0)
    moe = dataclasses.replace(cfg, num_experts=4, top_k=2, moe_d_ff=64)
    with pytest.raises(NotImplementedError, match="MoE"):
        init_model(g, moe, device="cpu")
    for kind in "MRS":
        with pytest.raises(NotImplementedError, match="not ported"):
            init_block(g, cfg, kind)
    params = init_model(g, cfg, device="cpu")
    cache = init_cache(cfg, 1, 8, cfg.dtype, device="cpu")
    with pytest.raises(NotImplementedError, match="sliding-window"):
        decode_step(params, cache, torch.zeros(1, 1, dtype=torch.long),
                    torch.tensor(0), cfg, window=4)


def test_entry_points_default_to_the_card():
    """Without a device argument the model and cache go to the card,
    and raise where there is none (this container)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    cfg = get_config("granite-3-8b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, 1, 8, cfg.dtype)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_model(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"w": np.zeros(2, np.float32)})
