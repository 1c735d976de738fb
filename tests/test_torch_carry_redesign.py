"""The redesigned merge-path carry step (K4/K2's fix-up) against the JAX
package on the CPU.

The kernels run only on the card (``tests/test_torch_cuda.py`` holds the
fused multiply bitwise against the two-call path and within tolerance of
the plain version there). Here the same seeded inputs go through the
reference (``repro.kernels.merge_spmv.merge_spmv_partials`` and
``repro.spmm.kernels._merge_spmm_partials`` in interpret mode, then the
reference's ``carry_out_fixup``) and through the port:

* ``merge_spmv(plain=True)`` and ``csr_spmm(plain=True)`` on the
  reference's plan carried across and on the port's own plan, with one
  row across more than 100 spans and spans with no nonzero, at k = 1, 8
  and 33;
* the warp-per-run fix-up of ``csrc/merge_spmm.cu`` emulated in float32
  (head detection, the run's end, the lane slots' split of a run's
  entries, the xor butterfly, the column passes of k = 33) on the real
  carries of that plan and on carries made up to hold runs of more than
  100 entries with empty spans (-1 pairs) inside them and runs that end
  around the kernel's first scan of 32 entries, against the port's plain
  ``carry_out_fixup_plain`` and the reference's ``carry_out_fixup`` (its
  (P, R) partials built from the carries);
* the one allocation of a merge multiply (``merge_out_views``) has the
  C entries' layout;
* the CPU wrappers take the plain versions and count no call or launch.

Tolerance: ``1e-4 * max(1, max|want|)`` (float32 sums in other orders: the
reference's one-hot matmul, ``index_add_``, the warp's slots), as on the
card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import core as J
from repro.kernels import merge_spmv as JMS
from repro.spmm import kernels as JK

from repro_torch import interop
from repro_torch.core import coo_to_csr
from repro_torch.data import matrices as TM
from repro_torch.kernels import merge_spmv as TMS
from repro_torch.kernels import ops as TOPS
from repro_torch.spmm import csr_spmm
from repro_torch.spmm import kernels as TK
from torch_threads import two_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")
SPANS = 256
DENSE_ROW = 11


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


def _triplets():
    """Row 11 holds all 6,000 columns (it crosses ~170 of 256 spans), rows
    600..1399 are empty (spans with no nonzero), the rest a diagonal and
    random entries."""
    m, n = 2000, 6000
    rng = np.random.default_rng(22)
    diag = np.r_[0:600]
    rows = np.concatenate([np.full(n, DENSE_ROW), diag,
                           rng.integers(1400, m, 500)])
    cols = np.concatenate([np.arange(n), diag, rng.integers(0, n, 500)])
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return rows, cols, vals, (m, n)


@pytest.fixture(scope="module")
def plans():
    rows, cols, vals, shape = _triplets()
    jr = J.coo_to_csr(J.to_coo(rows, cols, vals, shape))
    jp = JMS.merge_plan(jr, SPANS)
    carried = interop.merge_plan_from_arrays(
        {"cols": np.asarray(jp.cols), "vals": np.asarray(jp.vals),
         "seg": np.asarray(jp.seg), "row_starts": np.asarray(jp.row_starts),
         "r_width": jp.r_width}, device=CPU)
    csr = coo_to_csr(TM.as_coo((rows, cols, vals, shape), device=CPU))
    own = TMS.merge_plan(csr, SPANS)
    assert bool((own.span_len == 0).any())
    return {"shape": shape, "jp": jp, "csr": csr, "carried": carried,
            "own": own}


def _reference(jp, X, m):
    """The reference's partials kernel (interpret mode) and its
    ``carry_out_fixup``: ``merge_spmv_partials`` for one column, else
    ``_merge_spmm_partials`` over all k columns in one tile."""
    n, k = X.shape
    x_pad = jnp.zeros((-(-n // 128) * 128, k), jnp.float32).at[:n].set(X)
    if k == 1:
        partials = JMS.merge_spmv_partials(
            jp.cols, jp.vals, jp.seg, x_pad[:, 0], r_width=jp.r_width,
            interpret=True)
    else:
        partials = JK._merge_spmm_partials(
            jp.cols, jp.vals, jp.seg, x_pad, r_width=jp.r_width, k_tile=k,
            interpret=True)
    return np.asarray(JMS.carry_out_fixup(partials, jp.row_starts,
                                          m)).reshape(m, k)


def warp_fixup_emulated(carry_row, carry_val, y):
    """``merge_carry_fixup_kernel`` in float32 on the CPU, warp by warp:
    entry e's warp returns unless e heads a run of entries naming one row
    (-1 skipped); the run ends at the first later entry that names another
    row; each pass of up to 32 columns gives every column kc lanes (a power
    of two >= the pass's width) and slot s of the 32 / kc takes the run's
    entries i = s, s + S, ... in order; the xor butterfly adds the slots.
    Adds into ``y`` [m, k] float32 in place. (The kernel adds +0 where
    this skips an entry, so only the sign of a zero sum can differ.)"""
    carry_row = np.asarray(carry_row)
    carry_val = np.asarray(carry_val, np.float32).reshape(len(carry_row), -1)
    n, k = carry_val.shape
    lanes = np.arange(32)
    for e in range(n):
        r = carry_row[e]
        if r < 0:
            continue
        q = e - 1
        while q >= 0 and carry_row[q] < 0:
            q -= 1
        if q >= 0 and carry_row[q] == r:
            continue                                # not the head
        end = e + 1
        while end < n and carry_row[end] in (r, -1):
            end += 1
        for j0 in range(0, k, 32):
            w = min(32, k - j0)
            kc = 1
            while kc < w:
                kc *= 2
            S = 32 // kc
            acc = np.zeros((S, kc), np.float32)     # lane s * kc + c
            for f in range(e, end):
                if carry_row[f] == r:
                    acc[(f - e) % S, :w] += carry_val[f, j0:j0 + w]
            tot = acc.reshape(-1)
            off = kc
            while off < 32:
                tot = tot + tot[lanes ^ off]
                off *= 2
            y[r, j0:j0 + w] += tot[:w]
    return y


@pytest.mark.parametrize("k", [1, 8, 33])
def test_plain_multiply_against_the_reference_on_carried_and_own_plans(
        plans, k):
    """``merge_spmv(plain=True)`` (k = 1) and ``csr_spmm(plain=True)``
    against the reference's partials kernel and ``carry_out_fixup`` on its
    plan; the dense row's carries span more than 100 spans, and the
    emulated warp fix-up on those carries gives the same answer."""
    m, n = plans["shape"]
    X = np.random.default_rng(k).standard_normal((n, k)).astype(np.float32)
    want = _reference(plans["jp"], jnp.asarray(X), m)
    Xt = torch.from_numpy(X)
    for which in ("carried", "own"):
        plan = plans[which]
        got = csr_spmm(plans["csr"], Xt, plan=plan, plain=True)
        _close(got.numpy(), want)
        if k == 1:
            got1 = TOPS.merge_spmv(plans["csr"], Xt[:, 0], plan=plan,
                                   plain=True)
            _close(got1.numpy(), want[:, 0])
        y, cr, cv = TMS.merge_partials_plain(plan, Xt, m)
        assert int((cr == DENSE_ROW).sum()) >= 100
        emu = warp_fixup_emulated(cr.numpy(), cv.numpy(), y.numpy().copy())
        _close(emu, want)


def _made_up_carries(k, seed):
    """2P carries in the partials kernels' form (rows never decrease, a
    span's second slot -1 when it has one row) with one row across 150
    spans that holds empty spans ((-1, -1) pairs) inside its run, runs of
    two entries (a row shared by neighbouring spans), runs whose ends fall
    inside and just past the kernel's 32-entry first scan, and a run that
    reaches the last entry."""
    rng = np.random.default_rng(seed)
    rows = []
    r = 0
    rows += [r, r + 1]                          # a span of two rows
    r += 1
    for i in range(150):                        # row r across 150 spans
        rows += [-1, -1] if i % 37 == 5 else [r, -1]
    r += 1
    for _ in range(20):                         # shared boundary rows
        rows += [r - 1 if rng.random() < 0.5 else r, r]
        r += 1
    for length in (3, 9, 15, 16, 17, 31, 33, 70):   # 2 entries a length
        rows += [r, -1] * length
        rows += [r, r + 1]
        r += 2
    rows += [-1, -1, r, -1, r, -1]
    rows += [r] * 2 * 40                        # reaches the last entry
    carry_row = np.asarray(rows, np.int32)
    carry_val = rng.standard_normal((carry_row.size, k)).astype(np.float32)
    carry_val[carry_row < 0] = 0.0
    return carry_row, carry_val, r + 1


def _reference_fixup_of_carries(carry_row, carry_val, m):
    """The reference's ``carry_out_fixup`` on (P, R, k) partials that hold
    span p's two carries at their rows' offsets from the span's first
    row."""
    P = carry_row.size // 2
    k = carry_val.shape[1]
    pairs = carry_row.reshape(P, 2)
    starts = np.where(pairs[:, 0] >= 0, pairs[:, 0], 0).astype(np.int32)
    partials = np.zeros((P, 128, k), np.float32)
    for e in np.flatnonzero(carry_row >= 0):
        p = e // 2
        partials[p, carry_row[e] - starts[p]] += carry_val[e]
    row_starts = np.concatenate([starts, [m]]).astype(np.int32)
    return np.asarray(JMS.carry_out_fixup(jnp.asarray(partials),
                                          jnp.asarray(row_starts), m))


@pytest.mark.parametrize("k", [1, 8, 33])
def test_warp_fixup_emulation_on_made_up_runs(k):
    """The emulated warp fix-up, the port's plain ``carry_out_fixup`` (the
    CPU path of the wrapper) and the reference's ``carry_out_fixup`` agree
    on runs longer than 100 entries with empty spans inside."""
    carry_row, carry_val, m = _made_up_carries(k, seed=k)
    assert (carry_row[2:302] == -1).sum() >= 150 + 4
    y0 = np.random.default_rng(100 + k).standard_normal((m, k)).astype(
        np.float32)
    want = _reference_fixup_of_carries(carry_row, carry_val, m) + y0
    plain = TMS.carry_out_fixup(torch.from_numpy(y0.copy()),
                                torch.from_numpy(carry_row),
                                torch.from_numpy(carry_val))
    emu = warp_fixup_emulated(carry_row, carry_val, y0.copy())
    _close(plain.numpy(), want)
    _close(emu, want)


def test_merge_out_views_lay_out_the_c_entries_allocation():
    """``y`` at offset 0, ``carry_row`` (int32) after ``m * k`` floats,
    ``carry_val`` after ``2P`` more; every element of the allocation
    belongs to exactly one view; the K4 form is one-dimensional."""
    m, k, P = 7, 3, 5
    buf = TMS.merge_out(m, k, P, CPU)
    assert buf.dtype == torch.float32 and buf.numel() == m * k + 2 * P * (
        k + 1)
    y, cr, cv = TMS.merge_out_views(buf, m, k, P)
    assert y.shape == (m, k) and cr.shape == (2 * P,) and cr.dtype == \
        torch.int32 and cv.shape == (2 * P, k)
    base = buf.data_ptr()
    assert y.data_ptr() == base
    assert cr.data_ptr() == base + 4 * m * k
    assert cv.data_ptr() == base + 4 * (m * k + 2 * P)
    buf.fill_(0)
    y.fill_(1)
    cr.fill_(0x3f800000)            # the bits of 1.0f
    cv.fill_(1)
    assert bool((buf == 1).all())
    cr.copy_(torch.arange(2 * P, dtype=torch.int32) - 1)
    assert torch.equal(buf[m * k:m * k + 2 * P].view(torch.int32),
                       torch.arange(2 * P, dtype=torch.int32) - 1)
    yv, crv, cvv = TMS.merge_out_views(TMS.merge_out(m, 1, P, CPU), m, 1, P,
                                       vector=True)
    assert yv.shape == (m,) and crv.shape == (2 * P,) and cvv.shape == (
        2 * P,)


def test_cpu_wrappers_take_the_plain_versions_and_count_nothing(plans):
    """On CPU tensors ``ops.merge_spmv`` and ``csr_spmm`` give the plain
    answers and make no C call: no fused call, no partials or carry
    launch is counted."""
    m, n = plans["shape"]
    csr, plan = plans["csr"], plans["own"]
    counters = (TMS.merge_spmv_fused, "calls"), (TK.merge_spmm_fused,
                                                 "calls"), \
        (TMS.merge_spmv_partials, "launches"), \
        (TK._merge_spmm_partials, "launches"), \
        (TMS.carry_out_fixup, "launches")
    before = [getattr(f, a) for f, a in counters]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(n)
                         .astype(np.float32))
    X = torch.stack([x, 2 * x], 1)
    y = TOPS.merge_spmv(csr, x, plan=plan)
    Y = csr_spmm(csr, X, plan=plan)
    assert torch.equal(y, TOPS.merge_spmv(csr, x, plan=plan, plain=True))
    assert torch.equal(Y, csr_spmm(csr, X, plan=plan, plain=True))
    assert torch.equal(TMS.merge_spmv_fused(plan, x, m), y)
    assert torch.equal(TK.merge_spmm_fused(plan, X, m), Y)
    assert [getattr(f, a) for f, a in counters] == before


def test_plan_check_runs_on_a_plans_first_launch(plans):
    """The wrappers' plan check validates a plan it has not seen (a CPU
    plan is refused before any pointer reaches C) and keeps nothing from
    a refused plan."""
    plan = TMS.merge_plan(plans["csr"], 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TMS._check_plan(plan)
    assert plan._ptrs == () and plan._checked == ()
