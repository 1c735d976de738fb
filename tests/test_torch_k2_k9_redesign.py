"""The contracts around the redesigned K2 (merge-path CSR SpMM) and K9's
tensor-core kernel, against the JAX package on the CPU.

The kernels run only on the card (``tests/test_torch_cuda.py`` holds them
against their plain versions there). Here the same seeded numpy inputs go
through the reference (its Pallas kernels in interpret mode) and through
the port's plain Python:

* the exact three-term split of f32 weights into bf16 that K9's
  tensor-core kernel makes (``kernels.moe_group_matmul.split_bf16x3``):
  ``hi + mid + lo == w`` bitwise over exponents -100..100, for +-0,
  powers of two and full 24-bit significands, Inf/NaN -> (w, 0, 0);
* the split product, emulated with the three bf16 terms and summed in
  float64, against the reference's ``moe_group_matmul_padded``;
* the route ``kernels.ops.moe_group_matmul`` takes by the tokens' dtype
  (bf16: the tensor-core kernel at every size), against the reference;
* K2's function (the plain merge partials and the carry step) at the
  widths the new kernel lays out differently (k = 2, 3, 16, 64) on the
  reference's carried plan and the port's own. The redesign adds no
  host-side metadata: the kernel cuts each span into chains itself.

Tolerance: float32, ``rtol = atol = 2e-4`` (the reference suite's; the
sums run in another order); the emulated split product against the
float64 product of the unsplit weights: ``1e-12`` relative (both are
float64 sums of the same exact products).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import core as J
from repro.kernels import moe_group_matmul as JK9
from repro.kernels import ops as JOPS
from repro.kernels.merge_spmv import merge_plan as j_merge_plan
from repro.spmm import kernels as JK

from repro_torch import interop
from repro_torch.core import coo_to_csr
from repro_torch.data import matrices as TM
from repro_torch.interop import _float_t
from repro_torch.kernels import merge_spmv as TMS
from repro_torch.kernels import moe_group_matmul as TK9
from repro_torch.kernels import ops as TOPS
from repro_torch.spmm import csr_spmm
from torch_threads import two_threads  # noqa: F401 (autouse)

RTOL = ATOL = 2e-4
CPU = "cpu"


def _is_bf16(t):
    """Every value of the bf16 tensor ``t`` taken to f32 has its low 16
    bits clear (so it is that bf16 value exactly)."""
    bits = t.to(torch.float32).view(torch.int32)
    return bool(((bits & 0xFFFF) == 0).all())


def _exact(w):
    hi, mid, lo = TK9.split_bf16x3(w)
    assert all(t.dtype == torch.bfloat16 and _is_bf16(t)
               for t in (hi, mid, lo))
    total = hi.double() + mid.double() + lo.double()
    assert torch.equal(total, w.double())
    return hi, mid, lo


# --------------------------------------------------------------------------
# K9: the exact three-term split
# --------------------------------------------------------------------------
@pytest.mark.parametrize("lo_exp,hi_exp", [(-100, -50), (-50, 0), (0, 50),
                                           (50, 101)])
def test_split_is_exact_over_exponents(lo_exp, hi_exp):
    """Random f32 significands (all 24 bits drawn) at every exponent of
    the range, both signs: the three bf16 terms sum to w bitwise."""
    rng = np.random.default_rng(lo_exp + 200)
    n = 20000
    sig = rng.integers(1 << 23, 1 << 24, n).astype(np.float64)
    exp = rng.integers(lo_exp, hi_exp, n)
    sign = rng.choice([-1.0, 1.0], n)
    w = torch.from_numpy((sign * np.ldexp(sig, exp - 23)).astype(np.float32))
    assert bool(torch.isfinite(w).all())
    hi, mid, lo = _exact(w)
    # hi is w truncated to bf16; the terms shrink by at least 2^8 each
    assert torch.equal(hi.float().view(torch.int32),
                       w.view(torch.int32) & -65536)
    nz = mid != 0
    assert bool((mid.float()[nz].abs()
                 < hi.float()[nz].abs() * 2.0 ** -7).all())


def test_split_of_zeros_powers_and_full_significands():
    powers = torch.tensor([2.0 ** e for e in range(-100, 101)])
    hi, mid, lo = _exact(powers)
    assert torch.equal(hi.float(), powers)
    assert float(mid.float().abs().max()) == 0.0 == float(
        lo.float().abs().max())
    zeros = torch.tensor([0.0, -0.0])
    hi, mid, lo = _exact(zeros)
    assert torch.equal(torch.signbit(hi), torch.tensor([False, True]))
    # every significand bit set: all three terms are needed
    full = torch.tensor([float((1 << 24) - 1) * 2.0 ** e
                         for e in range(-120, 80, 7)])
    full = torch.cat([full, -full])
    assert torch.equal(full.double().abs() * 2.0 ** -torch.frexp(
        full.double())[1].double() * 2 ** 24, torch.full_like(
            full.double(), (1 << 24) - 1))
    hi, mid, lo = _exact(full)
    assert bool((lo != 0).all()) and bool((mid != 0).all())


def test_split_of_nonfinite_weights():
    w = torch.tensor([float("inf"), -float("inf"), float("nan"), 1.5])
    hi, mid, lo = TK9.split_bf16x3(w)
    assert torch.equal(hi.float()[:2], w[:2]) and bool(hi.float()[2].isnan())
    assert float(mid.float()[:3].abs().max()) == 0.0
    assert float(lo.float()[:3].abs().max()) == 0.0


@pytest.mark.parametrize("sizes", [[10, 0, 130, 1], [0, 300, 0, 2, 129]])
def test_split_product_matches_pallas(sizes):
    """The tensor-core kernel's arithmetic, emulated: bf16 rows times each
    of the three bf16 terms, summed in float64, equals the float64 product
    with the unsplit weights and the Pallas kernel (interpret mode) on
    every real row."""
    rng = np.random.default_rng(sum(sizes))
    E, K, N = len(sizes), 256, 128
    tokens = rng.standard_normal((sum(sizes), K)).astype(np.float32)
    w = (rng.standard_normal((E, K, N)) * K ** -0.5).astype(np.float32)
    w[0, 3, 5] = np.float32(3.0e-39)   # subnormal: split within 2^-126
    gp = TOPS.moe_group_pad(torch.from_numpy(tokens).to(torch.bfloat16),
                            torch.tensor(sizes), E, K)
    lhs, te = gp.lhs, gp.tile_expert.long()
    nm = lhs.shape[0] // 128
    tw = torch.from_numpy(w)
    terms = TK9.split_bf16x3(tw)
    a = lhs.double().view(nm, 128, K)
    emulated = sum(torch.bmm(a, t.double()[te]) for t in terms)
    exact = torch.bmm(a, tw.double()[te])
    scale = float(exact.abs().max())
    assert float((emulated - exact).abs().max()) <= 1e-12 * scale
    jl = jnp.asarray(np.asarray(lhs.float().numpy()), jnp.bfloat16)
    assert torch.equal(_float_t(np.asarray(jl), CPU), lhs)
    want = np.asarray(JK9.moe_group_matmul_padded(
        jl, jnp.asarray(w), jnp.asarray(gp.tile_expert.numpy()),
        interpret=True))
    real = np.zeros(lhs.shape[0], bool)
    real[gp.pos.numpy()] = True
    got = emulated.reshape(-1, N).float().numpy()
    np.testing.assert_allclose(got[real], want[real], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_moe_group_matmul_route_by_dtype(monkeypatch, dtype):
    """``ops.moe_group_matmul`` sends bf16 tokens to the tensor-core kernel
    at every size (it beat the decode kernel from 4 rows an expert up),
    f32 tokens to the decode kernel up to ``DECODE_ROWS_PER_EXPERT`` rows
    an expert and to the tiled kernel past it; each route gives the
    reference's answer (its Pallas kernel in interpret mode)."""
    calls = []
    for name in ("moe_group_matmul_decode", "moe_group_matmul_padded",
                 "moe_group_matmul_wgmma"):
        real = getattr(TK9, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(TK9, name, spy)
    E, K, N = 4, 128, 128
    limit = TOPS.DECODE_ROWS_PER_EXPERT * E
    tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if dtype == "bf16"
                else (torch.float32, jnp.float32))
    rng = np.random.default_rng(19)
    w = (rng.standard_normal((E, K, N)) * .1).astype(np.float32)
    for rows, sizes in ((limit, [limit, 0, 0, 0]),
                        (limit + 1, [1, 0, 0, limit])):
        route = ("moe_group_matmul_wgmma" if dtype == "bf16" else
                 "moe_group_matmul_decode" if rows == limit else
                 "moe_group_matmul_padded")
        assert TOPS.takes_decode_kernel(rows, E, tdt) == (
            route == "moe_group_matmul_decode")
        tokens = jnp.asarray(rng.standard_normal((rows, K)), jdt)
        calls.clear()
        got = TOPS.moe_group_matmul(_float_t(np.asarray(tokens), CPU),
                                    torch.from_numpy(w), torch.tensor(sizes))
        assert calls == [route]
        want = JOPS.moe_group_matmul(tokens, jnp.asarray(w),
                                     jnp.asarray(sizes, jnp.int32),
                                     interpret=True)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------
# K2: the function at the new kernel's lane layouts
# --------------------------------------------------------------------------
def _triplets():
    """The K4 suite's matrix: spans with no nonzero (rows 1000..2599 are
    empty), one-row spans and one row (11) across more than 20 spans."""
    m = n = 3000
    rng = np.random.default_rng(8)
    diag = np.r_[0:1000, 2600:3000]
    rows = np.concatenate([np.full(n, 11), diag,
                           rng.integers(2600, 3000, 500)])
    cols = np.concatenate([np.arange(n), diag, rng.integers(0, n, 500)])
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return rows, cols, vals, (m, n)


@pytest.mark.parametrize("k", [2, 3, 16, 64])
def test_k2_function_on_carried_and_own_plans(k):
    """K2's plain partials and the carry step (``csr_spmm(plain=True)``)
    on the reference's plan carried across and on the port's own plan,
    against the reference's ``csr_spmm`` (Pallas, interpret mode) on its
    plan: k = 2 and 3 (one column a lane, idle lanes), 16 and 64 (float4
    columns, 4 and 16 lanes a chain)."""
    rows, cols, vals, shape = _triplets()
    jr = J.coo_to_csr(J.to_coo(rows, cols, vals, shape))
    jp = j_merge_plan(jr, 203)
    carried = interop.merge_plan_from_arrays(
        {"cols": np.asarray(jp.cols), "vals": np.asarray(jp.vals),
         "seg": np.asarray(jp.seg), "row_starts": np.asarray(jp.row_starts),
         "r_width": jp.r_width}, device=CPU)
    csr = coo_to_csr(TM.as_coo((rows, cols, vals, shape), device=CPU))
    own = TMS.merge_plan(csr, 203)
    X = np.random.default_rng(k).standard_normal((shape[1], k)).astype(
        np.float32)
    want = np.asarray(JK.csr_spmm(jr, jnp.asarray(X), plan=jp,
                                  interpret=True))
    for plan in (carried, own):
        y, cr, cv = TMS.merge_partials_plain(plan, torch.from_numpy(X),
                                             shape[0])
        assert int((cr == 11).sum()) >= 20
        got = TMS.carry_out_fixup_plain(y, cr, cv)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(
            csr_spmm(csr, torch.from_numpy(X), plan=plan, plain=True).numpy(),
            want, rtol=RTOL, atol=ATOL)
