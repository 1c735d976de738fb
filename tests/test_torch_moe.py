"""The port's grouped GEMM (K9's plain version, ``kernels.ops``) and MoE
layer against the JAX package on the CPU.

The same numpy inputs go through the reference (the Pallas kernel in
interpret mode, ``jax.lax.ragged_dot``) and the port (the plain versions
that K9's wrapper runs for CPU tensors, the per-expert product). Answers
agree to ``rtol = atol = 2e-4`` (float32 sums in another order; the
reference's own kernel test uses the same tolerance).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import moe_group_matmul as JK9
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.models import moe as JMOE

from repro_torch.interop import _float_t
from repro_torch.kernels import moe_group_matmul as TK9
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF
from repro_torch.models import moe as TMOE

RTOL = ATOL = 2e-4
E, K, N = 4, 256, 384
# the group sizes of tests/test_kernels.py::test_moe_group_matmul, with
# empty groups
SIZES = [[10, 200, 0, 90], [0, 0, 300, 0], [75, 75, 75, 75],
         [300, 0, 0, 0]]


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _operands(seed=0, T=300, k=K, n=N):
    rng = np.random.default_rng(seed)
    tokens = rng.standard_normal((T, k)).astype(np.float32)
    w = (rng.standard_normal((E, k, n)) * .1).astype(np.float32)
    return tokens, w


def _bf16(a):
    """numpy float32 -> (JAX bf16 array, torch bf16 tensor), same bits."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, _float_t(np.asarray(j), "cpu")


@pytest.mark.parametrize("sizes", SIZES)
def test_ops_moe_group_matmul_matches_reference(sizes):
    tokens, w = _operands()
    gs = np.asarray(sizes, np.int32)
    want = JOPS.moe_group_matmul(jnp.asarray(tokens), jnp.asarray(w),
                                 jnp.asarray(gs), interpret=True)
    got = TOPS.moe_group_matmul(torch.from_numpy(tokens),
                                torch.from_numpy(w), torch.from_numpy(gs))
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want)
    # and the oracles agree
    _close(TREF.moe_group_matmul_ref(torch.from_numpy(tokens),
                                     torch.from_numpy(w),
                                     torch.from_numpy(gs)),
           JREF.moe_group_matmul_ref(jnp.asarray(tokens), jnp.asarray(w),
                                     jnp.asarray(gs)))


def test_ops_moe_group_matmul_bf16_lhs_f32_rhs():
    """bf16 tokens times f32 weights (the full configs' mix): both sides
    take the bf16 values to f32 exactly and return f32."""
    tokens, w = _operands(1)
    gs = np.asarray(SIZES[0], np.int32)
    jt, tt = _bf16(tokens)
    want = JOPS.moe_group_matmul(jt, jnp.asarray(w), jnp.asarray(gs),
                                 interpret=True)
    got = TOPS.moe_group_matmul(tt, torch.from_numpy(w),
                                torch.from_numpy(gs))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    _close(got, want)


def test_ops_moe_group_matmul_pads_k_and_n():
    """K and N that are not multiples of 128 (the reduced widths) are
    zero-padded and cut back."""
    tokens, w = _operands(2, T=40, k=64, n=96)
    gs = np.asarray([9, 0, 31, 0], np.int32)
    want = JOPS.moe_group_matmul(jnp.asarray(tokens), jnp.asarray(w),
                                 jnp.asarray(gs), interpret=True)
    got = TOPS.moe_group_matmul(torch.from_numpy(tokens),
                                torch.from_numpy(w), torch.from_numpy(gs))
    assert got.shape == (40, 96)
    _close(got, want)


@pytest.mark.parametrize("lhs_dtype", ["f32", "bf16"])
def test_padded_plain_matches_pallas_interpret(lhs_dtype):
    """K9's plain version against the Pallas kernel on the same padded
    operands (the port's group padding of SIZES[0], an expert id past E
    in the last tile, which both clamp)."""
    tokens, w = _operands(3)
    gp = TOPS.moe_group_pad(torch.from_numpy(tokens),
                            torch.tensor(SIZES[0]), E, K)
    lhs = gp.lhs.numpy()
    te = gp.tile_expert.numpy().copy()
    te[-1] = E + 3
    if lhs_dtype == "bf16":
        jl, tl = _bf16(lhs)
    else:
        jl, tl = jnp.asarray(lhs), torch.from_numpy(lhs)
    want = JK9.moe_group_matmul_padded(jl, jnp.asarray(w), jnp.asarray(te),
                                       interpret=True)
    got = TK9.moe_group_matmul_padded(tl, torch.from_numpy(w),
                                      torch.from_numpy(te))
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want)


def _bf16_ulp(a):
    """One bf16 step at each value of ``a`` (float32 numpy), counted at
    ``max(|a|, 1)``: near zero, f32 sums in another order differ by more
    than a step of the value itself."""
    e = np.frexp(np.maximum(np.abs(a), 1.0).astype(np.float32))[1]
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("case", ["out_bf16", "rhs_bf16"])
def test_padded_wrapper_takes_the_reference_dtypes(case):
    """K9's wrapper (its plain version on the CPU) against the Pallas
    kernel with a bf16 output (f32 sums cast once, as the reference's
    ``acc.astype(out_dtype)``) and with bf16 weights (widened to f32,
    exactly), within one bf16 step of the reference's answer (at
    ``max(|answer|, 1)``), and the f32 answer within the file's
    tolerance."""
    tokens, w = _operands(7)
    gp = TOPS.moe_group_pad(torch.from_numpy(tokens),
                            torch.tensor(SIZES[2]), E, K)
    jl, tl = _bf16(gp.lhs.numpy())
    te = gp.tile_expert.numpy()
    if case == "out_bf16":
        jw, tw = jnp.asarray(w), torch.from_numpy(w)
        kw = {"out_dtype": jnp.bfloat16}
        tkw = {"out_dtype": torch.bfloat16}
    else:
        (jw, tw), kw, tkw = _bf16(w), {}, {}
    want = JK9.moe_group_matmul_padded(jl, jw, jnp.asarray(te),
                                       interpret=True, **kw)
    got = TK9.moe_group_matmul_padded(tl, tw, torch.from_numpy(te), **tkw)
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape
    assert got.dtype == (torch.bfloat16 if case == "out_bf16"
                         else torch.float32)
    diff = np.abs(got.float().numpy() - want)
    assert (diff <= _bf16_ulp(want)).all(), float(diff.max())
    if case == "rhs_bf16":                       # an f32 answer
        _close(got, want)


def test_group_pad_layout():
    """The padding equals the reference's rule: each group starts at a
    multiple of 128 in a worst-case length, tile ids clipped to E - 1,
    the real padded length is the last group pointer."""
    gs = torch.tensor([10, 200, 0, 90])
    tokens = torch.arange(300 * 2, dtype=torch.float32).view(300, 2)
    gp = TOPS.moe_group_pad(tokens, gs, 4, 128)
    assert gp.lhs.shape == (384 + 4 * 128, 128)
    assert gp.tile_expert.tolist() == [0, 1, 1, 3, 3, 3, 3]
    assert int(gp.n_rows) == 128 + 256 + 128
    assert gp.pos[:10].tolist() == list(range(10))
    assert gp.pos[10:12].tolist() == [128, 129]
    assert gp.pos[210] == 384
    assert torch.equal(gp.lhs[gp.pos, :2], tokens)
    assert float(gp.lhs.abs().sum()) == float(tokens.abs().sum())


def test_padded_plain_zeroes_tiles_past_n_rows():
    lhs = torch.ones((384, 128))
    w = torch.ones((2, 128, 128))
    te = torch.tensor([0, 1, 1], dtype=torch.int32)
    out = TK9.moe_group_matmul_padded(
        lhs, w, te, n_rows=torch.tensor([256], dtype=torch.int32))
    assert float(out[:256].min()) == 128.0
    assert float(out[256:].abs().max()) == 0.0


def test_cpu_tensors_take_the_plain_version_uncounted():
    before = TK9.moe_group_matmul_padded.launches
    TOPS.moe_group_matmul(torch.ones((4, 128)), torch.ones((2, 128, 128)),
                          torch.tensor([3, 1]))
    assert TK9.moe_group_matmul_padded.launches == before


def test_padded_rejects_bad_shapes():
    with pytest.raises(ValueError):
        TK9.moe_group_matmul_padded(torch.ones((100, 128)),
                                    torch.ones((1, 128, 128)),
                                    torch.zeros(1, dtype=torch.int32))


@pytest.fixture(scope="module")
def moe_case():
    """One MoE layer of granite's reduced widths: JAX params and input,
    and the reference's answers on both routes."""
    cfg = JMOE.MoEConfig(64, 64, 8, 4)
    p = JMOE.moe_init(jax.random.PRNGKey(0), cfg)
    x = np.random.default_rng(4).standard_normal((2, 8, 64)).astype(
        np.float32)
    want = {}
    for use_kernel in (False, True):
        out, aux = JMOE.moe_apply(p, cfg._replace(use_kernel=use_kernel),
                                  jnp.asarray(x))
        want[use_kernel] = (np.asarray(out), float(aux))
    stats = JMOE.expert_load_stats(p, cfg, jnp.asarray(x))
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), p)
    return cfg, tp, x, want, stats


@pytest.mark.parametrize("use_kernel", [False, True])
def test_moe_apply_matches_reference(moe_case, use_kernel):
    cfg, tp, x, want, _ = moe_case
    tcfg = TMOE.MoEConfig(*cfg[:4], use_kernel=use_kernel)
    out, aux = TMOE.moe_apply(tp, tcfg, torch.from_numpy(x))
    assert out.shape == x.shape and out.dtype == torch.float32
    _close(out, want[use_kernel][0])
    assert abs(float(aux) - want[use_kernel][1]) <= 1e-6
    # the two routes of the port agree as the reference's do
    _close(want[True][0], want[False][0])


def test_expert_load_stats_matches_reference(moe_case):
    cfg, tp, x, _, stats = moe_case
    got = TMOE.expert_load_stats(tp, TMOE.MoEConfig(*cfg[:4]),
                                 torch.from_numpy(x))
    assert got["counts"].tolist() == np.asarray(stats["counts"]).tolist()
    assert abs(float(got["max_over_mean"])
               - float(stats["max_over_mean"])) <= 1e-6
    assert abs(float(got["variance"]) - float(stats["variance"])) <= 1e-4
