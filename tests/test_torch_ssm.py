"""The port's Mamba-2 SSM mixer and the SSM/hybrid LM stacks against the
JAX package on the CPU.

Inputs and parameters come from numpy under a seed. A module's parameters
go to both sides as the same numpy arrays; a model's are the reference's
tree (stacked over groups, shapes from ``jax.eval_shape`` of its
``init_params``) filled from numpy and carried across with
``interop.lm_params_from_arrays``. Float32 results agree within ``1e-5 *
max(1, max|ref|)`` (float32 sums in another order), unless a test says
why not; greedy tokens are equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.models import model as JM
from repro.models import ssm as JS

from repro_torch.configs import get_config
from repro_torch.interop import lm_params_from_arrays
from repro_torch.launch import serve as tserve
from repro_torch.models import accounting as TACC
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from torch_threads import two_threads  # noqa: F401 (autouse)

REL = 1e-5
B = 2
CFG = dict(d_model=32, d_state=8, headdim=8, chunk=8)   # H = 8 heads


def _rel_close(got, want, rel=REL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


def _leaf(rng, name: str, shape, d_model: int) -> np.ndarray:
    """One parameter of the reference's init distributions, from numpy."""
    if name == "A_log":
        a = np.log(rng.uniform(1.0, 16.0, shape))
    elif name == "dt_bias":
        a = np.log(np.expm1(rng.uniform(1e-3, 1e-1, shape)))
    elif name in ("scale", "norm_scale", "D"):
        a = 1.0 + 0.1 * rng.standard_normal(shape)
    elif name in ("b", "bias"):
        a = 0.1 * rng.standard_normal(shape)
    else:
        fan_in = d_model if name == "embed" else shape[-2]
        a = rng.standard_normal(shape) * fan_in ** -0.5
    return a.astype(np.float32)


def _numpy_tree(shapes, seed: int, d_model: int):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, s: _leaf(rng, path[-1].key, s.shape, d_model), shapes)


def _ssm_params(cfg: JS.SSMConfig, seed: int = 0):
    shapes = jax.eval_shape(lambda: JS.ssm_init(jax.random.PRNGKey(0), cfg))
    tree = _numpy_tree(shapes, seed, cfg.d_model)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            jax.tree_util.tree_map(torch.from_numpy, tree))


def _u(S, seed=1, d=CFG["d_model"], dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        dtype)


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------
FWD_CASES = [(16, False), (16, True), (13, False), (13, True)]


@pytest.fixture(scope="module")
def forward_cases():
    """The reference's chunked forward of every case, in one jitted call:
    (params, u, initial state or None, output) per case."""
    jcfg = JS.SSMConfig(**CFG)
    jp, tp = _ssm_params(jcfg)
    s0 = np.random.default_rng(2).standard_normal(
        (B, jcfg.nheads, jcfg.headdim, jcfg.d_state)).astype(np.float32)
    args = [(_u(S), s0 if with_state else None) for S, with_state in
            FWD_CASES]
    outs = jax.jit(lambda p, xs: [JS.ssm_forward(p, jcfg, u, s)
                                  for u, s in xs])(
        jp, [(jnp.asarray(u), None if s is None else jnp.asarray(s))
             for u, s in args])
    return tp, [(u, s, np.asarray(o)) for (u, s), o in zip(args, outs)]


@pytest.mark.parametrize("case", range(len(FWD_CASES)),
                         ids=[f"S{S}-{'state' if st else 'zero'}"
                              for S, st in FWD_CASES])
def test_ssm_forward_matches_reference(forward_cases, case):
    """Chunked forward with S a multiple of the chunk (8) and not (the
    last chunk padded with zero ``dt`` and ``log a``), from a zero or a
    given initial state."""
    tp, cases = forward_cases
    u, s0, want = cases[case]
    got = TS.ssm_forward(tp, TS.SSMConfig(**CFG), torch.from_numpy(u),
                         None if s0 is None else torch.from_numpy(s0))
    _rel_close(got.numpy(), want)


@pytest.mark.parametrize("S", [16, 13])
def test_ssm_forward_matches_its_naive_recurrence(S):
    cfg = TS.SSMConfig(**CFG)
    _, tp = _ssm_params(JS.SSMConfig(**CFG), seed=3)
    u = torch.from_numpy(_u(S, seed=4))
    _rel_close(TS.ssm_forward(tp, cfg, u).numpy(),
               TS.ssm_forward_naive(tp, cfg, u).numpy())


def test_ssm_decode_matches_reference_step_by_step():
    jcfg, tcfg = JS.SSMConfig(**CFG), TS.SSMConfig(**CFG)
    jp, tp = _ssm_params(jcfg, seed=5)
    rng = np.random.default_rng(6)
    conv = rng.standard_normal((B, 3, jcfg.d_inner + 2 * jcfg.d_state)
                               ).astype(np.float32)
    st = rng.standard_normal((B, jcfg.nheads, jcfg.headdim, jcfg.d_state)
                             ).astype(np.float32)
    jc = JS.SSMCache(jnp.asarray(conv), jnp.asarray(st))
    tc = TS.SSMCache(torch.from_numpy(conv), torch.from_numpy(st))
    u = _u(6, seed=7)
    jdecode = jax.jit(lambda p, u, c: JS.ssm_decode(p, jcfg, u, c))
    for t in range(6):
        jo, jc = jdecode(jp, jnp.asarray(u[:, t:t + 1]), jc)
        to, tc = TS.ssm_decode(tp, tcfg, torch.from_numpy(u[:, t:t + 1]),
                               tc)
        _rel_close(to.numpy(), np.asarray(jo))
        _rel_close(tc.conv_state.numpy(), np.asarray(jc.conv_state))
        _rel_close(tc.ssm_state.numpy(), np.asarray(jc.ssm_state))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_prefill_state_matches_reference(dtype):
    """``_ssm_prefill_state``: the conv state in the input's dtype, the SSM
    state in float32, on both sides. bf16 inputs: both round the in_proj
    product to bf16, a float32 sum in another order may round to the
    neighbouring bf16 value (2^-8 of it), so 1e-2 * max(1, max|ref|)."""
    jcfg, tcfg = JS.SSMConfig(**CFG), TS.SSMConfig(**CFG)
    jp, tp = _ssm_params(jcfg, seed=8)
    u = _u(13, seed=9)
    ju = jnp.asarray(u).astype(dtype)
    tu = torch.from_numpy(u).to(getattr(torch, dtype))
    want = jax.jit(lambda p, u: JM._ssm_prefill_state(p, jcfg, u))(jp, ju)
    got = TM._ssm_prefill_state(tp, tcfg, tu)
    rel = REL if dtype == "float32" else 1e-2
    for g, w in zip(got, want):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        _rel_close(g.float().numpy(), np.asarray(w.astype(jnp.float32)),
                   rel)
    assert str(got.conv_state.dtype) == f"torch.{dtype}"
    assert got.ssm_state.dtype == torch.float32


def test_ssm_gradient_finite_where_the_reference_overflows():
    """A chunk whose decay sum passes ~88 (here dt ~ 0.7, A up to 16 over
    16 steps): the reference takes exp of the unmasked differences, gets
    inf above the diagonal and a NaN gradient (a fault of the reference,
    ROADMAP.md queue 3); the port masks the exponent first. Forward values
    agree; the port's gradient is finite and equals its naive
    recurrence's."""
    cfg = dict(CFG, chunk=16)
    jcfg, tcfg = JS.SSMConfig(**cfg), TS.SSMConfig(**cfg)
    jp, tp = _ssm_params(jcfg, seed=10)
    jp["A_log"] = jnp.log(jnp.linspace(1.0, 16.0, jcfg.nheads))
    jp["dt_bias"] = jnp.zeros((jcfg.nheads,))
    tp["A_log"] = torch.from_numpy(np.array(jp["A_log"]))
    tp["dt_bias"] = torch.zeros(jcfg.nheads)
    u = _u(16, seed=11)

    def fwd(p):
        return JS.ssm_forward(p, jcfg, jnp.asarray(u))
    jout, jg = jax.jit(lambda p: (fwd(p), jax.grad(
        lambda q: fwd(q).sum())(p)))(jp)
    assert bool(jnp.isnan(jg["A_log"]).any())
    grads = {}
    for name, fn in (("chunked", TS.ssm_forward),
                     ("naive", TS.ssm_forward_naive)):
        p = {k: ({kk: vv.clone().requires_grad_(True) for kk, vv in
                  v.items()} if isinstance(v, dict)
                 else v.clone().requires_grad_(True)) for k, v in tp.items()}
        out = fn(p, tcfg, torch.from_numpy(u))
        out.sum().backward()
        grads[name] = p["A_log"].grad
        if name == "chunked":
            _rel_close(out.detach().numpy(), np.asarray(jout))
    assert bool(torch.isfinite(grads["chunked"]).all())
    _rel_close(grads["chunked"].numpy(), grads["naive"].numpy(), 1e-4)


# ---------------------------------------------------------------------------
# mamba2 and jamba reduced: forward, prefill, greedy decode
# ---------------------------------------------------------------------------
P, STEPS = 13, 4          # a prompt that is not a multiple of the chunk


def _lm_pair(arch: str, seed: int = 0):
    """(reference config, port config, reference params as jnp, the port's
    carried params) for ``arch`` reduced."""
    jcfg = jget_config(arch, reduced=True)
    tcfg = get_config(arch, reduced=True)
    shapes = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    tree = _numpy_tree(shapes, seed, jcfg.d_model)
    return (jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree),
            lm_params_from_arrays(tree, tcfg, device="cpu"))


def _serve_both(arch: str) -> dict:
    """The forward, the prefill (logits and caches) and STEPS greedy
    decode steps of ``arch`` reduced on both sides; on the reference's
    side one jitted function for the forward and the prefill, one for a
    decode step."""
    jcfg, tcfg, jp, tp = _lm_pair(arch)
    rng = np.random.default_rng(12)
    prompts = rng.integers(0, jcfg.vocab, (B, P)).astype(np.int32)
    s_max = P + STEPS + 1
    out = {"tcfg": tcfg, "tparams": tp}
    (jh, jaux), (lg, c) = jax.jit(lambda p, t: (
        JM.forward(p, jcfg, t),
        JM.prefill(p, jcfg, t, s_max, cache_dtype=jnp.float32)))(
            jp, jnp.asarray(prompts))
    with torch.no_grad():
        th, taux = TM.forward(tp, tcfg, torch.from_numpy(prompts))
    out["forward"] = ((np.asarray(jh), float(jaux)),
                      (th.numpy(), float(taux)))

    df = jax.jit(lambda p, tok, c, pos: JM.decode_step(p, jcfg, tok, c, pos))
    jcache = [tuple(np.asarray(t) for t in s) for s in c]
    jl, jt = [np.asarray(lg)], [np.argmax(np.asarray(lg), -1)]
    for i in range(STEPS):
        lg, c = df(jp, jnp.asarray(jt[-1][:, None], jnp.int32), c,
                   jnp.full((B,), P + i, jnp.int32))
        jl.append(np.asarray(lg))
        jt.append(np.argmax(jl[-1], -1))

    lg, c = TM.prefill(tp, tcfg, torch.from_numpy(prompts), s_max,
                       cache_dtype=torch.float32)
    tcache = [type(s)(*(t.clone() for t in s)) for s in c]
    tl, tt = [lg.numpy()], [torch.argmax(lg, -1).numpy()]
    for i in range(STEPS):
        lg, c = TM.decode_step(tp, tcfg,
                               torch.from_numpy(tt[-1][:, None].astype(
                                   np.int32)), c,
                               torch.full((B,), P + i, dtype=torch.int32))
        tl.append(lg.numpy())
        tt.append(torch.argmax(lg, -1).numpy())
    out["prefill"] = (jcache, tcache)
    out["decode"] = ((np.stack(jt, 1), jl), (np.stack(tt, 1), tl))
    return out


@pytest.fixture(scope="module", params=["mamba2-1.3b",
                                        "jamba-1.5-large-398b"])
def served(request):
    return _serve_both(request.param)


def test_lm_forward_matches_reference(served):
    (jh, jaux), (th, taux) = served["forward"]
    _rel_close(th, jh)
    assert abs(taux - jaux) <= 1e-6


def test_lm_prefill_caches_match_reference(served):
    """Every slot's caches after the prefill, with the reference's dtypes:
    KV caches in ``cache_dtype``, an SSM slot's conv state in the compute
    dtype and its state in float32 (not ``cache_dtype``)."""
    jcache, tcache = served["prefill"]
    assert len(jcache) == len(tcache) == served["tcfg"].group_size
    for js, ts in zip(jcache, tcache):
        assert type(ts).__name__ in ("KVCache", "SSMCache")
        for j, t in zip(js, ts):
            assert t.shape == j.shape
            assert str(t.dtype).replace("torch.", "") == str(j.dtype)
            _rel_close(t.numpy(), j)


def test_lm_greedy_decode_matches_reference(served):
    (jt, jl), (tt, tl) = served["decode"]
    np.testing.assert_array_equal(tt, jt)
    for got, want in zip(tl, jl):
        _rel_close(got, want)


def test_init_cache_matches_reference_structure():
    """jamba's per-slot caches from ``init_cache``: the same kinds, shapes
    and dtypes as the reference's (bf16 KV and conv states, float32 SSM
    states)."""
    arch = "jamba-1.5-large-398b"
    jcfg, tcfg = jget_config(arch, reduced=True), get_config(arch,
                                                             reduced=True)
    want = jax.eval_shape(lambda: JM.init_cache(jcfg, B, 24))
    got = TM.init_cache(tcfg, B, 24)
    assert [type(c).__name__ for c in got] == \
        [type(c).__name__ for c in want]
    for js, ts in zip(want, got):
        for j, t in zip(js, ts):
            assert tuple(t.shape) == j.shape
            assert str(t.dtype).replace("torch.", "") == str(j.dtype)
            assert not t.any()


def test_serve_mamba2_reduced_on_cpu():
    """``serve --mode lm --arch mamba2-1.3b --reduced --device cpu`` in
    this process: tokens in range, the parameter count of the accounting,
    and the decode run from the prefill's caches gives the tokens that a
    full forward over the generated prefix predicts."""
    res = tserve.main(["--mode", "lm", "--arch", "mamba2-1.3b", "--reduced",
                       "--device", "cpu", "--batch", "2", "--prompt-len",
                       "8", "--gen", "4"])
    gen, cfg = res["tokens"], res["cfg"]
    assert gen.shape == (2, 4)
    assert ((gen >= 0) & (gen < cfg.vocab)).all()
    assert res["n_params"] == TACC.count_params(cfg)
    seq = torch.cat([res["prompts"], torch.from_numpy(gen[:, :-1])], dim=1)
    with torch.no_grad():
        h, _ = TM.forward(res["params"], cfg, seq)
        lg = TM.logits_from_hidden(res["params"], cfg, h[:, 7:])
    np.testing.assert_array_equal(lg.argmax(-1).numpy(), gen)
