"""The work plan of K1/K8 (``csrc/sellcs_spmm.cu``): how the SELL-C-σ
width-row stream is cut into work items, and how the partials of a cut
group are added back together.

A work item is one slice's group of 32 consecutive lanes over a range of
at most ``depth`` width-rows. A group's walk starts at its slice's first
width-row in the stream and stops at its longest real row (``row_len``;
the slice's width without it); a walk deeper than ``depth`` is cut into
pieces, so one warp never walks a dense row alone. A group of one piece
writes its slots straight into Y. In a group of several pieces, each lane
whose entries span ``n >= 2`` pieces owns ``n`` scratch rows (one partial
per piece, written by the items) and one segment of the combine kernel,
which adds them in a fixed order and writes the lane's slot.

The plan depends on the stream only (``slice_ptr``, its depth base and
``row_len``), never on X, k or ``col_map``: K8 on the full X and K1 on
the gathered slab ``X[col_map]`` run the same items and add in the same
order. It is built with torch ops on the stream's device and cached on
the ``slice_ptr`` tensor (:func:`cached_slots_plan`), as the merge plan
is on its CSR.
"""
from __future__ import annotations

import ctypes
import dataclasses
import time
from typing import Optional

import torch

DEPTH = 32        # width-rows per work item (chosen on the card, PERF.md)
LANES = 32        # lanes per group (a warp)


@dataclasses.dataclass(eq=False)
class SlotsPlan:
    """K1/K8's items and combine segments for one stream (see the module
    docstring). ``items`` rows are ``{slot0, w_lo, w_hi, base, g_end,
    piece, split, lane0 * 64 + n_live}`` (``n_live``: 1 + the last lane
    with entries in the item); ``segs`` rows ``{src, count, slot, 0}``:
    the scratch rows ``src .. src + count - 1`` hold one lane's partials,
    in piece order, and their sum is Y's row ``slot``. ``split`` is the
    group's split id, -1 for a group of one piece, -2 for one whose every
    lane reaches the group's end (the kernel reads no ``row_len`` for
    it)."""
    items: torch.Tensor          # int32[n_items, 8]
    lane_base: torch.Tensor      # int32[max(n_split, 1) * 32]
    segs: torch.Tensor           # int32[max(n_segs, 1), 4]
    n_segs: int
    n_scratch: int               # scratch rows the items write
    num_slices: int
    chunk: int
    depth: int
    deepest: int                 # the deepest group walk, in width-rows
    build_s: float
    sources: tuple = ()          # (row_len, depth_ptr) the plan was built from
    versions: tuple = ()         # their and slice_ptr's version counters
    # the data/cols the K1/K8 wrapper last validated with this plan
    _checked: tuple = dataclasses.field(default=(None, None), init=False,
                                        repr=False)

    @property
    def n_items(self) -> int:
        return int(self.items.shape[0])

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.items, self.lane_base, self.segs))

    def c_args(self) -> "PlanArgs":
        """The plan as the C entry points take it (``PlanArgs`` in
        ``csrc/sellcs_spmm.cu``), built once: a launch passes its address.
        It points into this plan's tensors and its ``row_len``."""
        args = getattr(self, "_c_args", None)
        if args is None:
            row_len = self.sources[0] if self.sources else None
            args = PlanArgs(
                self.items.data_ptr(), self.n_items,
                self.lane_base.data_ptr(), self.segs.data_ptr(), self.n_segs,
                0 if row_len is None else row_len.data_ptr(),
                0 if row_len is None else int(row_len.numel()), self.chunk)
            self._c_args = args
        return args


class PlanArgs(ctypes.Structure):
    """``struct PlanArgs`` of ``csrc/sellcs_spmm.cu``."""
    _fields_ = [("items", ctypes.c_void_p), ("n_items", ctypes.c_longlong),
                ("lane_base", ctypes.c_void_p), ("segs", ctypes.c_void_p),
                ("n_segs", ctypes.c_longlong),
                ("row_len", ctypes.c_void_p),
                ("len_slots", ctypes.c_longlong),
                ("chunk", ctypes.c_longlong)]


def _lens(row_len: Optional[torch.Tensor], S: int, C: int, G: int,
          start: torch.Tensor, end: torch.Tensor) -> Optional[torch.Tensor]:
    """Row lengths as int64[S * G, 32] (lanes past C hold 0). ``row_len``
    may cover only the first slices; the rest must be empty."""
    if row_len is None:
        return None
    if row_len.numel() % C:
        raise ValueError(f"row_len must cover whole slices of {C} lanes, "
                         f"got {row_len.numel()} entries")
    nr = row_len.numel() // C
    if nr > S:
        raise ValueError(f"row_len covers {nr} slices, the stream {S}")
    if nr < S and bool((end[nr:] > start[nr:]).any()):
        raise ValueError("row_len must cover every slice with width-rows")
    lens = torch.zeros((S, G * LANES), dtype=torch.int64,
                       device=start.device)
    lens[:nr, :C] = row_len.reshape(nr, C).long()
    return lens.reshape(S * G, LANES)


def build_slots_plan(slice_ptr: torch.Tensor, *, num_slices: int,
                     chunk: int, row_len: Optional[torch.Tensor] = None,
                     depth_ptr: Optional[torch.Tensor] = None,
                     depth: int = DEPTH) -> SlotsPlan:
    """The plan of the stream whose slices ``s`` hold width-rows
    ``[slice_ptr[s], slice_ptr[s + 1])``. ``depth_ptr`` (default
    ``slice_ptr``; it may cover only the first slices) is each slice's
    depth base: width-row ``w`` of slice ``s`` sits at depth ``w -
    depth_ptr[s]`` of its rows, negative bases for a stream cut
    mid-slice. With ``row_len`` (int32 over the first slices' slots) a
    lane stops at its row's end; without it every lane walks the slice's
    width."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    t0 = time.perf_counter()
    S, C = int(num_slices), int(chunk)
    dev = slice_ptr.device
    if slice_ptr.numel() != S + 1:
        raise ValueError("slice_ptr must have num_slices + 1 entries")
    ptr = slice_ptr.long()
    start, end = ptr[:-1], ptr[1:]
    base = start.clone()
    if depth_ptr is not None:
        nd = min(int(depth_ptr.numel()) - 1, S)
        base[:nd] = depth_ptr[:nd].long()
    G = -(-C // LANES)
    lens = _lens(row_len, S, C, G, start, end)
    n_groups = S * G
    g_start = start.repeat_interleave(G)
    g_base = base.repeat_interleave(G)
    g_end = end.repeat_interleave(G)
    if lens is not None:
        g_end = torch.minimum(g_end, g_base + lens.amax(1))
        g_end = torch.maximum(g_end, g_start)
    g_depth = g_end - g_start
    pieces = ((g_depth + depth - 1) // depth).clamp(min=1)
    gid = torch.repeat_interleave(torch.arange(n_groups, device=dev), pieces)
    first = torch.cumsum(pieces, 0) - pieces
    piece = torch.arange(gid.numel(), device=dev) - first[gid]
    w_lo = g_start[gid] + piece * depth
    w_hi = torch.minimum(w_lo + depth, g_end[gid])
    lane0 = (torch.arange(n_groups, device=dev) % G) * LANES
    slot0 = (torch.arange(n_groups, device=dev) // G) * C + lane0
    is_split = pieces > 1
    # -1: one piece; -2: one piece whose every lane reaches g_end (the
    # kernel then reads no row_len); >= 0: the split group's id
    lane = torch.arange(LANES, device=dev)
    if lens is None:
        full = ~is_split
    else:
        live = lane[None] < (C - lane0)[:, None]
        reach = torch.minimum(g_end[:, None], g_base[:, None] + lens)
        full = ((reach >= g_end[:, None]) | ~live).all(1) & ~is_split
    split_id = torch.where(
        is_split, torch.cumsum(is_split.long(), 0) - 1,
        torch.where(full, torch.full_like(pieces, -2),
                    torch.full_like(pieces, -1)))
    # 1 + the last lane with entries in each item (the kernel skips the
    # warps past it in later pieces)
    if lens is None:
        reach_g = g_end[:, None].expand(-1, LANES)
    else:
        reach_g = torch.minimum(g_end[:, None], g_base[:, None] + lens)
    n_live = torch.zeros_like(gid)
    for i0 in range(0, gid.numel(), 1 << 20):   # bounded [items, 32] temp
        sl = slice(i0, i0 + (1 << 20))
        g = gid[sl]
        has = ((reach_g[g] > w_lo[sl, None])
               & (lane[None] < (C - lane0[g])[:, None]))
        n_live[sl] = torch.where(has, lane[None] + 1,
                                 torch.zeros_like(has, dtype=torch.long)
                                 ).amax(1)
    items = torch.stack([slot0[gid], w_lo, w_hi, g_base[gid], g_end[gid],
                         piece, split_id[gid], lane0[gid] * 64 + n_live], 1)

    # the lanes of split groups with entries in two or more pieces
    sg = torch.nonzero(is_split).squeeze(1)
    live = lane[None] < (C - lane0[sg])[:, None]
    if lens is not None:
        stop = torch.minimum(g_end[sg, None], g_base[sg, None] + lens[sg])
    else:
        stop = g_end[sg, None].expand(-1, LANES)
    n_l = torch.where(live, ((stop - g_start[sg, None]).clamp(min=0)
                             + depth - 1) // depth,
                      torch.zeros_like(stop)).reshape(-1)
    many = n_l >= 2
    cnt = torch.where(many, n_l, torch.zeros_like(n_l))
    lb = torch.cumsum(cnt, 0) - cnt
    lane_base = torch.where(many, lb, torch.full_like(lb, -1))
    n_rows = int(cnt.sum()) if cnt.numel() else 0
    slots = (slot0[sg, None] + lane[None]).reshape(-1)

    # one combine segment a lane with partials: its rows, its slot
    segs = torch.stack([lb[many], cnt[many], slots[many],
                        torch.zeros_like(cnt[many])], 1)
    n_segs = int(segs.shape[0])
    if not n_segs:
        segs = torch.zeros((1, 4), dtype=torch.int64, device=dev)
    if not lane_base.numel():
        lane_base = torch.full((LANES,), -1, dtype=torch.int64, device=dev)
    deepest = int(g_depth.max()) if g_depth.numel() else 0
    if items.numel() and int(items[:, :5].abs().max()) >= 2 ** 31:
        raise ValueError("the stream is too large for int32 plan fields")
    plan = SlotsPlan(items.to(torch.int32).contiguous(),
                     lane_base.to(torch.int32).contiguous(),
                     segs.to(torch.int32).contiguous(), n_segs, n_rows, S,
                     C, int(depth), deepest, 0.0, (row_len, depth_ptr),
                     _versions(slice_ptr, row_len, depth_ptr))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    plan.build_s = time.perf_counter() - t0
    return plan


def _versions(*ts) -> tuple:
    return tuple(None if t is None else t._version for t in ts)


def cached_slots_plan(slice_ptr: torch.Tensor, *, num_slices: int,
                      chunk: int, row_len: Optional[torch.Tensor] = None,
                      depth_ptr: Optional[torch.Tensor] = None,
                      depth: int = DEPTH) -> SlotsPlan:
    """:func:`build_slots_plan`, built on first use and kept on the
    ``slice_ptr`` tensor, so every later multiply of the stream reuses it;
    rebuilt when ``row_len`` or ``depth_ptr`` is another tensor or any of
    the three was written in place since."""
    plans = slice_ptr.__dict__.setdefault("_slots_plans", {})
    key = (int(num_slices), int(chunk), int(depth), id(row_len),
           id(depth_ptr))
    plan = plans.get(key)
    if (plan is not None and plan.sources[0] is row_len
            and plan.sources[1] is depth_ptr
            and plan.versions == _versions(slice_ptr, row_len, depth_ptr)):
        return plan
    plan = build_slots_plan(slice_ptr, num_slices=num_slices, chunk=chunk,
                            row_len=row_len, depth_ptr=depth_ptr,
                            depth=depth)
    plans[key] = plan
    return plan

