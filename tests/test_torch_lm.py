"""The port's LM serving path against the JAX package on the CPU.

The reference's parameters (``init_params(PRNGKey(0))``) are carried
across with ``interop.lm_params_from_arrays`` and numpy prompts [2, 8]
go through both sides' prefill and 4 greedy decode steps. Greedy tokens
are equal; logits (float32 compute) agree within ``1e-4 * max(1,
max|ref|)``: float32 sums in another order, over a few layers.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.configs import registry as jregistry
from repro.models import accounting as JACC
from repro.models import attention as JATT
from repro.models import layers as JL
from repro.models.model import decode_step as jdecode
from repro.models.model import forward as jforward
from repro.models.model import init_params as jinit
from repro.models.model import prefill as jprefill

from repro_torch.configs import get_config, registry
from repro_torch.interop import lm_params_from_arrays
from repro_torch.launch import serve as tserve
from repro_torch.models import accounting as TACC
from repro_torch.models import attention as TATT
from repro_torch.models import layers as TL
from repro_torch.models.model import (decode_step, forward, init_params,
                                      prefill)
from torch_threads import two_threads  # noqa: F401 (autouse)

ARCH = "granite-moe-1b-a400m"
B, P, STEPS = 2, 8, 4
S_MAX = P + STEPS
REL = 1e-4


def _rel_close(got, want, rel=REL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


def _t(a):
    return torch.from_numpy(np.array(a))


def _configs(arch, **overrides):
    """The reference's and the port's reduced config of ``arch``, with the
    same overrides (jnp.bfloat16 becomes torch.bfloat16)."""
    jcfg = dataclasses.replace(jget_config(arch, reduced=True), **overrides)
    tover = {k: (torch.bfloat16 if v is jnp.bfloat16 else v)
             for k, v in overrides.items()}
    return jcfg, dataclasses.replace(get_config(arch, reduced=True), **tover)


def _serve_both(arch, steps=STEPS, **overrides):
    """Prefill + ``steps`` greedy decode steps on both sides with the
    reference's random parameters (and, for the vision frontend, the same
    patch embeddings ahead of the prompt). Returns per side: (tokens
    [B, 1 + steps], logits per step, caches after prefill as numpy)."""
    jcfg, tcfg = _configs(arch, **overrides)
    params = jinit(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, jcfg.vocab, (B, P)).astype(np.int32)
    off = jcfg.vision_tokens if jcfg.frontend == "vision" else 0
    vis = (rng.standard_normal((B, off, jcfg.vision_dim)).astype(np.float32)
           if off else None)
    s_max = S_MAX + off
    tparams = lm_params_from_arrays(
        jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")

    pf = jax.jit(lambda p, t, v: jprefill(p, jcfg, t, s_max,
                                          cache_dtype=jnp.float32,
                                          vision_embeds=v))
    df = jax.jit(lambda p, tok, c, pos: jdecode(p, jcfg, tok, c, pos))
    lg, c = pf(params, jnp.asarray(prompts),
               None if vis is None else jnp.asarray(vis))
    jcache = [(np.asarray(s.k), np.asarray(s.v)) for s in c]
    jl, jt = [np.asarray(lg)], [np.argmax(np.asarray(lg), -1)]
    for i in range(steps):
        tok = jnp.asarray(jt[-1][:, None], jnp.int32)
        lg, c = df(params, tok, c, jnp.full((B,), off + P + i, jnp.int32))
        jl.append(np.asarray(lg))
        jt.append(np.argmax(np.asarray(lg), -1))

    lg, c = prefill(tparams, tcfg, torch.from_numpy(prompts), s_max,
                    cache_dtype=torch.float32,
                    vision_embeds=None if vis is None else _t(vis))
    tcache = [(s.k.clone().numpy(), s.v.clone().numpy()) for s in c]
    tl, tt = [lg.numpy()], [torch.argmax(lg, -1).numpy()]
    for i in range(steps):
        tok = torch.from_numpy(tt[-1][:, None].astype(np.int32))
        lg, c = decode_step(tparams, tcfg, tok, c,
                            torch.full((B,), off + P + i, dtype=torch.int32))
        tl.append(lg.numpy())
        tt.append(torch.argmax(lg, -1).numpy())
    return ((np.stack(jt, 1), jl, jcache), (np.stack(tt, 1), tl, tcache),
            tparams, tcfg)


@pytest.fixture(scope="module", params=[False, True],
                ids=["ragged_dot", "kernel"])
def granite(request):
    return _serve_both(ARCH, moe_use_kernel=request.param)


def test_prefill_logits_and_caches_match_reference(granite):
    (_, jl, jc), (_, tl, tc), _, _ = granite
    _rel_close(tl[0], jl[0])
    assert len(tc) == len(jc) == 1
    for (tk, tv), (jk, jv) in zip(tc, jc):
        assert tk.shape == jk.shape == (2, B, S_MAX, 2, 16)
        _rel_close(tk, jk)
        _rel_close(tv, jv)


def test_greedy_decode_matches_reference(granite):
    (jt, jl, _), (tt, tl, _), _, _ = granite
    np.testing.assert_array_equal(tt, jt)
    for got, want in zip(tl[1:], jl[1:]):
        _rel_close(got, want)


def test_carried_params_match_accounting(granite):
    *_, tparams, tcfg = granite
    assert tcfg.param_count(tparams) == TACC.count_params(tcfg)
    assert len(tparams["layers"]) == tcfg.n_layers


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen3-4b",
                                  "musicgen-large", "mixtral-8x22b",
                                  "internvl2-2b"])
def test_other_attention_stacks_match_reference(arch):
    """QKV bias + dense SwiGLU (qwen2.5), qk-norm (qwen3), LayerNorm +
    GELU + sinusoidal positions (musicgen), sliding window + top-2 MoE
    (mixtral), the vision frontend's projected patch embeddings ahead of
    the prompt (internvl2): prefill and one decode step."""
    (jt, jl, _), (tt, tl, _), _, _ = _serve_both(arch, steps=1)
    np.testing.assert_array_equal(tt, jt)
    for got, want in zip(tl, jl):
        _rel_close(got, want)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_matches_reference(use_kernel):
    """The full-sequence forward (final-normed hidden states and the MoE
    load-balance loss) of granite REDUCED."""
    jcfg, tcfg = _configs(ARCH, moe_use_kernel=use_kernel)
    params = jinit(jax.random.PRNGKey(1), jcfg)
    tokens = np.random.default_rng(9).integers(
        0, jcfg.vocab, (B, 12)).astype(np.int32)
    jh, jaux = jax.jit(lambda p, t: jforward(p, jcfg, t))(
        params, jnp.asarray(tokens))
    tparams = lm_params_from_arrays(
        jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
    with torch.no_grad():
        th, taux = forward(tparams, tcfg, torch.from_numpy(tokens))
    _rel_close(th.numpy(), np.asarray(jh))
    assert abs(float(taux) - float(jaux)) <= 1e-6


def test_bf16_compute_prefill_logits():
    """bf16 activations (the full configs' compute dtype): both sides
    round activations to bf16 at the same points, but a float32 sum taken
    in another order can round to the neighbouring bf16 value (one step,
    2^-8 to 2^-7 of the value), and such flips travel through the two
    layers. Held to 2e-2 * max(1, max|ref|) (6.8e-3 * max measured)."""
    (_, jl, _), (_, tl, _), _, _ = _serve_both(
        ARCH, steps=0, compute_dtype=jnp.bfloat16, moe_use_kernel=True)
    _rel_close(tl[0], jl[0], rel=2e-2)


@pytest.mark.parametrize("window", [0, 3])
def test_flash_sdpa_matches_reference(window):
    """Chunked online-softmax attention at q_chunk = k_chunk = 4 over 10
    positions (ragged last chunk). Both sides round the float32 P and V
    to bf16 for the PV product; their P entries differ only by float32
    sums in another order, which on these inputs moves no entry across a
    bf16 rounding boundary, so the bound is float32's: 1e-5 absolute on
    outputs of order 1."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 10, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 10, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 10, 2, 16)).astype(np.float32)
    jcfg = JATT.AttnConfig(64, 4, 2, 16, sliding_window=window)
    tcfg = TATT.AttnConfig(64, 4, 2, 16, sliding_window=window)
    want = JATT.flash_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jcfg, q_chunk=4, k_chunk=4)
    got = TATT.flash_sdpa(_t(q), _t(k), _t(v), tcfg, q_chunk=4, k_chunk=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    # and the unchunked float32 attention of the port, within the bf16 PV
    # rounding (2^-8 relative per term, 6.7e-3 measured)
    mask = TATT.causal_mask(10, 10, 0, window)
    full = TATT._sdpa(_t(q), _t(k), _t(v), mask, tcfg)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=0,
                               atol=2e-2)


def test_apply_rope_matches_reference():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    pos = (np.arange(5)[None] + np.array([[0], [7]])).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500.0)
    got = TL.apply_rope(_t(x), _t(pos), 500.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("layer", ["rmsnorm", "layernorm", "conv", "dense"])
def test_layers_match_reference(layer):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 6, 16)).astype(np.float32)
    p = {"scale": rng.standard_normal(16).astype(np.float32),
         "bias": rng.standard_normal(16).astype(np.float32),
         "w": rng.standard_normal((4, 16)).astype(np.float32),
         "b": rng.standard_normal(16).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    if layer == "rmsnorm":
        want, got = JL.rmsnorm(jp, jnp.asarray(x)), TL.rmsnorm(tp, _t(x))
    elif layer == "layernorm":
        want, got = JL.layernorm(jp, jnp.asarray(x)), TL.layernorm(tp, _t(x))
    elif layer == "conv":
        want, ws = JL.causal_conv1d(jp, jnp.asarray(x))
        got, ts = TL.causal_conv1d(tp, _t(x))
        np.testing.assert_allclose(ts.numpy(), np.asarray(ws))
    else:
        dp = {"w": rng.standard_normal((16, 5)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
        want = JL.dense({k: jnp.asarray(v) for k, v in dp.items()},
                        jnp.asarray(x))
        got = TL.dense({k: _t(v) for k, v in dp.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", list(registry()))
def test_count_params_matches_reference(arch):
    assert TACC.count_params(registry()[arch]) \
        == JACC.count_params(jregistry()[arch])
    assert TACC.count_params(registry()[arch], active_only=True) \
        == JACC.count_params(jregistry()[arch], active_only=True)


def test_init_params_matches_accounting_and_ssm_raises():
    """``init_params`` draws every leaf the accounting counts, for an
    attention stack and, since the SSM mixer is ported, for mamba2."""
    for arch in (ARCH, "mamba2-1.3b"):
        cfg = get_config(arch, reduced=True)
        params = init_params(torch.Generator().manual_seed(0), cfg)
        assert cfg.param_count(params) == TACC.count_params(cfg)


def test_serve_lm_on_cpu():
    """``serve --mode lm`` on the CPU: tokens in range; K9's plain version
    (--impl plain) and the per-expert route (--impl ref) generate the same
    tokens from the same seed."""
    argv = ["--mode", "lm", "--arch", ARCH, "--reduced", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8", "--gen", "4"]
    res = tserve.main(argv + ["--impl", "plain"])
    gen = res["tokens"]
    assert gen.shape == (2, 4)
    assert ((gen >= 0) & (gen < 256)).all()
    assert res["n_params"] == TACC.count_params(res["cfg"])
    assert res["cfg"].moe_use_kernel and res["cfg"].moe_plain
    ref = tserve.main(argv + ["--impl", "ref"])
    assert not ref["cfg"].moe_use_kernel
    np.testing.assert_array_equal(ref["tokens"], gen)
    with pytest.raises(SystemExit):
        tserve.main(argv + ["--impl", "kernel"])
