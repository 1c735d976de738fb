"""The contracts around the redesigned K1/K8 (SELL-C-σ slot SpMM and its
fused-gather form), against the JAX package on the CPU.

The kernels run only on the card (``tests/test_torch_cuda.py`` holds them
against their plain versions there). Here the same seeded inputs go
through the reference (its Pallas kernel in interpret mode, on its own
arrays carried across with ``interop``) and through the port's plain
Python:

* the work plan (``spmm.slots_plan``): its items cover every real
  (slot, width-row) entry exactly once and no padding entry, none is
  deeper than the plan's depth, every slot is written once, on small
  mawi_like (a dense row), hhh_like and road_like streams and on
  merge-chunk shards that start mid-slice (a negative depth base);
* the split-and-combine, emulated in float64 from the plan (items write
  partials, each combine segment adds one lane's), equals
  ``sellcs_slots_plain`` with ``row_len``, and both equal the
  reference's ``sellcs_slots`` at finite X;
* a NaN/Inf in X row 0: the port's masked plain version puts it only
  into the slots whose rows hold column 0; the reference's padding
  entries (value 0, column 0) carry it into every slot with padding too
  (a fault of the reference, left unfixed);
* the CPU wrapper takes the plain version and counts no launch.

Tolerance: the emulation against the plain version ``1e-5 * max(1,
max|plain|)`` (float32 sums in another order against float64); against
the reference ``rtol = atol = 2e-4`` (the reference suite's).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import core as J
from repro import spmm as JS
from repro.spmm import kernels as JK

from repro_torch import interop
from repro_torch.data import matrices as TM
from repro_torch.spmm import distributed as TD
from repro_torch.spmm import kernels as TK
from repro_torch.spmm import sellcs_spmm
from repro_torch.spmm import slots_plan as SP
from torch_threads import two_threads  # noqa: F401 (autouse)

RTOL = ATOL = 2e-4
CASES = {"mawi_like": 0.02, "hhh_like": 0.05, "road_like": 0.02}
C = 32


def _pair(name):
    """The reference's SELL-C-σ of a suite matrix and the port's carried
    copy of its arrays (the same stream in both packages)."""
    trip = TM.test_suite(CASES[name])[name].make()
    js = JS.coo_to_sellcs(J.to_coo(*trip), c=C, sigma=2 * C)
    d = {f: np.asarray(getattr(js, f)) for f in (
        "data", "cols", "slice_ptr", "slice_of", "row_perm", "row_len")}
    d.update(shape=js.shape, chunk=js.chunk, sigma=js.sigma, nnz=js.nnz)
    return js, interop.sellcs_from_arrays(d, device="cpu"), trip


def _x(n, k, seed=0):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(
        np.float32)


def _entries(data, slice_ptr, row_len, depth_ptr, num_slices):
    """The real (slot, width-row) entries of a stream, as a set."""
    ptr = slice_ptr.long().numpy()
    base = ptr[:-1].copy()
    if depth_ptr is not None:
        nd = min(depth_ptr.numel() - 1, num_slices)
        base[:nd] = depth_ptr[:nd].long().numpy()
    lens = np.zeros(num_slices * C, np.int64)
    lens[:row_len.numel()] = row_len.long().numpy()
    out = set()
    for s in range(num_slices):
        for w in range(ptr[s], ptr[s + 1]):
            for lane in np.nonzero(w - base[s] < lens[s * C:(s + 1) * C])[0]:
                out.add((s * C + int(lane), w))
    return out


def _walk(plan, row_len):
    """What the kernel walks: per item and lane, its stop and entries.
    Returns (covered list of (slot, w), writes of Y slots, per-item depth)."""
    rl = None if row_len is None else row_len.long().tolist()
    covered, y_writes, part_writes = [], [], []
    lane_base = plan.lane_base.tolist()
    for slot0, w_lo, w_hi, base, g_end, piece, split, f7 in \
            plan.items.tolist():
        assert 0 <= w_hi - w_lo <= plan.depth
        lane0, n_live = f7 >> 6, f7 & 63
        live = []
        for t in range(min(SP.LANES, plan.chunk - lane0)):
            s = slot0 + t
            stop = g_end
            if rl is not None:
                stop = min(g_end, base + (rl[s] if s < len(rl) else 0))
            covered += [(s, w) for w in range(w_lo, min(w_hi, stop))]
            assert split != -2 or stop == g_end   # a full group
            if w_lo < min(w_hi, stop):
                live.append(t)
            if split < 0 or (piece == 0 and stop <= w_hi):
                y_writes.append(s)
            elif w_lo < stop:
                part_writes.append(lane_base[split * SP.LANES + t] + piece)
        assert n_live == (max(live) + 1 if live else 0)
    return covered, y_writes, part_writes


def _shards(ts):
    part = TD.partition_sellcs_nnz(ts, 3, num_chunks=2)
    return [sh for sp in part.chunk_plan[1] for sh in sp.shards
            if sh.width_rows]


@pytest.mark.parametrize("depth", [4, 16])
@pytest.mark.parametrize("name", ["mawi_like", "hhh_like", "road_like",
                                  "merge_chunks"])
def test_plan_covers_every_real_entry_once(name, depth):
    """Every real entry once, no padding entry, no item deeper than the
    plan's depth, every slot written once (straight, or by the combine
    segment of its lane), every scratch row written once and read by one
    segment."""
    if name == "merge_chunks":
        _, ts, _ = _pair("mawi_like")
        streams = [(sh.data, sh.slice_ptr, sh.t_row_len, sh.t_ptr,
                    sh.num_slices) for sh in _shards(ts)]
        assert any(int(sh.t_ptr.min()) < 0 for sh in _shards(ts))
    else:
        _, ts, _ = _pair(name)
        streams = [(ts.data, ts.slice_ptr, ts.row_len, None,
                    ts.num_slices)]
    for data, ptr, rl, dptr, S in streams:
        plan = SP.build_slots_plan(ptr, num_slices=S, chunk=C, row_len=rl,
                                   depth_ptr=dptr, depth=depth)
        covered, y_writes, part_writes = _walk(plan, rl)
        assert len(covered) == len(set(covered))
        assert set(covered) == _entries(data, ptr, rl, dptr, S)
        segs = plan.segs.tolist()[:plan.n_segs]
        assert sorted(y_writes + [slot for _, _, slot, _ in segs]) \
            == list(range(S * C))
        rows = [r for src, num, _, _ in segs for r in range(src, src + num)]
        assert all(num >= 2 for _, num, _, _ in segs)
        assert sorted(part_writes) == sorted(rows) \
            == list(range(plan.n_scratch))
    if name == "mawi_like":
        assert plan.deepest > 16 * depth and plan.n_segs >= 1


def test_plan_without_row_len_walks_the_slice_width():
    """Without ``row_len`` every lane walks its slice's width (the padding
    is read, as the reference reads it), still cut into pieces."""
    _, ts, _ = _pair("mawi_like")
    plan = SP.build_slots_plan(ts.slice_ptr, num_slices=ts.num_slices,
                               chunk=C, depth=8)
    covered, _, _ = _walk(plan, None)
    W = int(ts.slice_ptr[-1])
    assert len(covered) == W * C == len(set(covered))
    assert int((plan.items[:, 2] - plan.items[:, 1]).max()) <= 8


def _emulate(plan, data, cols, x, row_len, col_map=None):
    """The kernel's arithmetic from the plan, in float64: each item's lane
    partial, then each combine segment's sum."""
    k = x.shape[1]
    x = x.double().numpy()
    d, c = data.double().numpy(), cols.long().numpy()
    if col_map is not None:
        c = col_map.long().numpy()[c]
    y = np.full((plan.num_slices * C, k), np.nan)
    part = np.full((max(plan.n_scratch, 1), k), np.nan)
    rl = None if row_len is None else row_len.long().tolist()
    lane_base = plan.lane_base.tolist()
    for slot0, w_lo, w_hi, base, g_end, piece, split, f7 in \
            plan.items.tolist():
        lane0 = f7 >> 6
        for t in range(min(SP.LANES, C - lane0)):
            s = slot0 + t
            stop = g_end if rl is None else min(
                g_end, base + (rl[s] if s < len(rl) else 0))
            ws = np.arange(w_lo, max(min(w_hi, stop), w_lo))
            acc = (d[ws, lane0 + t, None] * x[c[ws, lane0 + t]]).sum(0)
            if split < 0 or (piece == 0 and stop <= w_hi):
                y[s] = acc
            elif w_lo < stop:
                part[lane_base[split * SP.LANES + t] + piece] = acc
    for src, num, slot, _ in plan.segs[:plan.n_segs].tolist():
        y[slot] = part[src:src + num].sum(0)
    return torch.from_numpy(y)


def _close(got, want, rel=1e-5):
    tol = rel * max(1.0, float(want.abs().max()))
    assert float((got.double() - want.double()).abs().max()) <= tol


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("name", ["mawi_like", "hhh_like"])
def test_split_and_combine_equals_plain_and_reference(name, k):
    """The emulated split-and-combine equals the plain version with
    ``row_len``, and both equal the reference's Pallas kernel (interpret
    mode) at finite X; on merge-chunk shards (negative depth bases) the
    emulation with K8's ``col_map`` equals the masked plain version."""
    js, ts, _ = _pair(name)
    n = js.shape[1]
    X = _x(n, k, k)
    plan = SP.build_slots_plan(ts.slice_ptr, num_slices=ts.num_slices,
                               chunk=C, row_len=ts.row_len, depth=4)
    kw = dict(num_slices=ts.num_slices, chunk=C)
    plain = TK.sellcs_slots_plain(ts.data, ts.cols, ts.slice_ptr,
                                  torch.from_numpy(X), row_len=ts.row_len,
                                  **kw)
    _close(_emulate(plan, ts.data, ts.cols, torch.from_numpy(X),
                    ts.row_len), plain)
    np_ = -(-n // 128) * 128
    x_pad = np.zeros((np_, k), np.float32)
    x_pad[:n] = X
    want = np.asarray(JK.sellcs_slots(
        js.data, js.cols, js.slice_of, jnp.asarray(x_pad), **kw, k_tile=k,
        interpret=True))[:, :k]
    np.testing.assert_allclose(plain.numpy(), want, rtol=RTOL, atol=ATOL)
    part = TD.partition_sellcs_nnz(ts, 3, num_chunks=2, compact_x=True)
    for sp in part.chunk_plan[1]:
        for p, sh in enumerate(sp.shards):
            if not sh.width_rows:
                continue
            kw = dict(num_slices=sh.num_slices, chunk=C,
                      row_len=sh.t_row_len)
            plan = SP.build_slots_plan(sh.slice_ptr, depth_ptr=sh.t_ptr,
                                       depth=4, **kw)
            plain = TK.sellcs_slots_plain(sh.data, sh.cols, sh.slice_ptr,
                                          torch.from_numpy(X),
                                          col_map=sh.col_map,
                                          depth_ptr=sh.t_ptr, **kw)
            _close(_emulate(plan, sh.data, sh.cols, torch.from_numpy(X),
                            sh.t_row_len, col_map=sh.col_map), plain)
            # the chunk entry, given the span's first depth, is the same
            first = int(sh.slice_ptr[int(sh.t_ids[0])] - sh.t_ptr[
                int(sh.t_ids[0])])
            got = TK.sellcs_slots_chunk(
                sh.data, sh.cols, sp.slice_of[p, :sh.width_rows],
                torch.from_numpy(X), slice_start=sp.slice_start,
                num_slices=sh.num_slices, chunk=C, col_map=sh.col_map,
                row_len=sh.t_row_len, first_depth=first)
            assert torch.equal(got, plain)


def test_nonfinite_x_row0_reaches_padding_only_in_the_reference():
    """X row 0 holds NaN and Inf. The port's masked plain version (what
    K1 computes with ``row_len``) makes exactly the slots whose rows
    hold column 0 non-finite; the reference also every slot with
    padding, through its padding entries (value 0, column 0, ``0 * NaN``),
    and slice 0, where it aims the width-rows that pad the stream to its
    grid step. A fault of the reference, left unfixed."""
    js, ts, trip = _pair("mawi_like")
    n = js.shape[1]
    X = _x(n, 2, 5)
    X[0] = [np.nan, np.inf]
    got = TK.sellcs_slots_plain(ts.data, ts.cols, ts.slice_ptr,
                                torch.from_numpy(X),
                                num_slices=ts.num_slices, chunk=C,
                                row_len=ts.row_len).numpy()
    np_ = -(-n // 128) * 128
    x_pad = np.zeros((np_, 2), np.float32)
    x_pad[:n] = X
    want = np.asarray(JK.sellcs_slots(
        js.data, js.cols, js.slice_of, jnp.asarray(x_pad),
        num_slices=js.num_slices, chunk=C, k_tile=2, interpret=True))[:, :2]
    rows, cols = np.asarray(trip[0]), np.asarray(trip[1])
    perm = ts.row_perm.long().numpy()
    hits = np.isin(perm, rows[cols == 0])               # slots naming col 0
    assert np.array_equal(~np.isfinite(got).all(1), hits)
    width = np.repeat(np.diff(ts.slice_ptr.long().numpy()), C)
    padded = ts.row_len.long().numpy() < width
    if int(ts.slice_ptr[-1]) % JK.W_TILE:     # its tile-padding width-rows
        padded[:C] = True                      # are aimed at slice 0
    assert np.array_equal(~np.isfinite(want).all(1), hits | padded)
    assert (padded & ~hits).sum() > 0                   # the fault shows
    fin = np.isfinite(want).all(1)                      # both finite
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


def test_cpu_wrapper_takes_plain_and_counts_no_launch():
    """CPU tensors: ``sellcs_slots`` (K1 and K8) is its plain version with
    the same ``row_len`` and depth base, and counts no launch; the
    multiply ``sellcs_spmm`` passes the stream's ``row_len``."""
    _, ts, _ = _pair("hhh_like")
    X = torch.from_numpy(_x(ts.shape[1], 3, 1))
    counts = (TK.sellcs_slots.launches, TK.sellcs_slots.fused_launches)
    kw = dict(num_slices=ts.num_slices, chunk=C, row_len=ts.row_len)
    assert torch.equal(TK.sellcs_slots(ts.data, ts.cols, ts.slice_ptr, X,
                                       **kw),
                       TK.sellcs_slots_plain(ts.data, ts.cols, ts.slice_ptr,
                                             X, **kw))
    cmap = torch.arange(ts.shape[1], dtype=torch.int32).flip(0)
    assert torch.equal(
        TK.sellcs_slots(ts.data, ts.cols, ts.slice_ptr, X.flip(0),
                        col_map=cmap, **kw),
        TK.sellcs_slots_plain(ts.data, ts.cols, ts.slice_ptr, X, **kw))
    assert torch.equal(sellcs_spmm(ts, X), sellcs_spmm(ts, X, plain=True))
    assert (TK.sellcs_slots.launches,
            TK.sellcs_slots.fused_launches) == counts
