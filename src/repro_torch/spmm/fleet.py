"""repro_torch.spmm.fleet — the operator registry behind ``serve --mode
fleet``, the port of ``repro.spmm.fleet``.

One serve process, many matrices: each tenant registers a COO and gets a
:class:`repro_torch.spmm.SparseOperator` back.

**Plan cache.** Realized plans are keyed on ``(matrix fingerprint, plan
spec, k-hint, impl)``, the fingerprint being the content hash of the
canonically ordered triplets (:func:`repro_torch.spmm.operator.
coo_fingerprint`, the reference's digest). A returning tenant (same
matrix, same knobs) installs the cached :class:`RealizedPlan` directly and
pays no selection, conversion or partition (its ``OperatorStats`` shows
zero builds). Tenants with the same matrix but other knobs share the
convert-time artifacts through one :class:`_PlanCache` per fingerprint
(the SELL-C-σ stream and each base partition). The paper's break-even
(§7: hundreds of multiplies to pay for one conversion) makes this the
difference between converting per tenant arrival and per distinct matrix.

**Device loss.** ``handle_device_loss(failed)`` re-deals every mesh
tenant's width-row stream over the survivors (``SparseOperator.shrink_to``
→ ``redeal_sellcs``: no σ-sort, no conversion) and swaps the shrunken
plans in; serving continues. ``failed`` are positions in the fleet's
``devices`` list, the counterpart of the reference's indices into
``jax.devices()``: a mesh may name one card at several positions (four
positions of ``cuda:0``), so a lost position is not a device identity.
Re-deal seconds land in ``fleet/redeal_s`` per tenant.

A :class:`repro_torch.runtime.StragglerMonitor` watches flush times fed
through ``observe_flush``; flagged flushes land in
``fleet/straggler_flags``.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.core.formats import COO
from repro_torch.core.selector import PlanSpec
from repro_torch.runtime.fault_tolerance import StragglerMonitor
from repro_torch.spmm.operator import (RealizedPlan, SparseOperator,
                                       _PlanCache, coo_fingerprint)


class FleetStats:
    """Fleet-level accounting (the per-operator build counters live on
    each operator's ``OperatorStats``)."""
    __slots__ = ("registered", "plan_cache_hits", "plan_cache_misses",
                 "evictions", "evicted_bytes", "device_losses")

    def __init__(self):
        self.registered = 0
        self.plan_cache_hits = 0
        self.plan_cache_misses = 0
        self.evictions = 0
        self.evicted_bytes = 0
        self.device_losses = 0

    def __repr__(self):
        return (f"FleetStats(registered={self.registered}, "
                f"hits={self.plan_cache_hits}, "
                f"misses={self.plan_cache_misses}, "
                f"evictions={self.evictions}, "
                f"evicted_bytes={self.evicted_bytes}, "
                f"device_losses={self.device_losses})")


def _spec_key(spec: Optional[PlanSpec]) -> Tuple:
    """Hashable identity of the plan knobs (canonicalized, so equivalent
    spellings share a cache line)."""
    if spec is None:
        return ()
    sp = spec.canonical()
    return (sp.num_devices, sp.mesh_shape, sp.num_chunks, sp.compact_x,
            sp.schedule, sp.algorithm, sp.structure)


class Fleet:
    """Registry of :class:`SparseOperator` tenants with a plan cache and
    device-loss re-deal.

    ::

        fleet = Fleet(devices=["cuda:0"] * 4)
        op = fleet.register("tenant-a", coo, PlanSpec(num_devices=4))
        y = op.matmul(x)
        fleet.handle_device_loss([3])      # re-deal onto positions 0-2

    ``devices`` are the mesh positions every operator's mesh plan takes
    (default: the machine's CUDA cards); a list may repeat a device.
    ``capacity`` bounds the tenant count, ``max_bytes`` the summed
    ``SparseOperator.storage_bytes``; either evicts the least recently
    registered tenants at register time, and the freed bytes land in
    ``fleet/evicted_bytes``.
    """

    def __init__(self, *, impl: str = "auto", feedback=None,
                 monitor: Optional[StragglerMonitor] = None,
                 capacity: Optional[int] = None,
                 max_bytes: Optional[int] = None,
                 devices: Optional[Sequence] = None):
        if capacity is not None and capacity < 1:
            raise ValueError("capacity must be >= 1 (or None)")
        if max_bytes is not None and max_bytes < 1:
            raise ValueError("max_bytes must be >= 1 (or None)")
        self._impl = impl
        self._feedback = feedback
        self._capacity = capacity
        self._max_bytes = max_bytes
        self._devices = None if devices is None else list(devices)
        self._ops: Dict[str, SparseOperator] = {}      # insertion = LRU age
        self._fingerprints: Dict[str, str] = {}        # tenant -> fp
        self._plan_keys: Dict[str, Tuple] = {}         # tenant -> cache key
        self._plans: Dict[Tuple, RealizedPlan] = {}
        self._artifacts: Dict[str, _PlanCache] = {}    # fp -> shared cache
        self._failed: set = set()
        self._flush_seq = 0
        self.monitor = monitor if monitor is not None else StragglerMonitor()
        self.stats = FleetStats()

    # -- registry ----------------------------------------------------------
    def tenants(self) -> List[str]:
        return list(self._ops)

    def get(self, tenant: str) -> SparseOperator:
        return self._ops[tenant]

    def __contains__(self, tenant: str) -> bool:
        return tenant in self._ops

    def __len__(self) -> int:
        return len(self._ops)

    def register(self, tenant: str, coo: COO,
                 spec: Optional[PlanSpec] = None, *, k_hint: int = 32,
                 num_spmvs: int = 1000) -> SparseOperator:
        """Build (or cache-hit) an operator for ``tenant``. The cache key
        is ``(fingerprint(coo), spec, k_hint, impl)``; on a hit the cached
        :class:`RealizedPlan` is installed directly, and the operator's
        ``OperatorStats`` shows zero SELL-C-σ and partition builds."""
        if tenant in self._ops:
            raise ValueError(f"tenant {tenant!r} already registered")
        fp = coo_fingerprint(coo)
        key = (fp, _spec_key(spec), int(k_hint), self._impl)
        cached = self._plans.get(key)
        artifacts = self._artifacts.setdefault(fp, _PlanCache())
        # after a loss, new mesh plans go only onto the survivors
        devices = self.live_devices() if self._failed else self._devices
        if cached is not None:
            op = SparseOperator(coo, cached, impl=self._impl,
                                k_hint=k_hint, num_spmvs=num_spmvs,
                                cache=artifacts, devices=devices)
            self.stats.plan_cache_hits += 1
            if obs.enabled():
                obs.current_registry().counter("fleet/plan_cache_hits").inc()
        else:
            op = SparseOperator(coo, spec, impl=self._impl, k_hint=k_hint,
                                num_spmvs=num_spmvs,
                                feedback=self._feedback, cache=artifacts,
                                devices=devices)
            self._plans[key] = op.plan
            self.stats.plan_cache_misses += 1
            if obs.enabled():
                obs.current_registry().counter(
                    "fleet/plan_cache_misses").inc()
        self._ops[tenant] = op
        self._fingerprints[tenant] = fp
        self._plan_keys[tenant] = key
        self.stats.registered += 1
        if obs.enabled():
            obs.current_registry().gauge("fleet/tenants").set(
                len(self._ops))
        if self._capacity is not None:
            while len(self._ops) > self._capacity:
                self.evict(next(iter(self._ops)))
        if self._max_bytes is not None:
            # the newest tenant is never evicted: the budget bounds the
            # fleet, and one over-budget matrix still serves
            while (len(self._ops) > 1
                   and self.total_storage_bytes() > self._max_bytes):
                victim = next(t for t in self._ops if t != tenant)
                self.evict(victim)
        return op

    def total_storage_bytes(self) -> int:
        """The summed ``SparseOperator.storage_bytes`` of every resident
        plan."""
        return sum(op.storage_bytes() for op in self._ops.values())

    def evict(self, tenant: str) -> None:
        """Drop a tenant; a fingerprint's artifacts and cached plans go
        with its last user. The freed plan bytes land in
        ``fleet/evicted_bytes``."""
        freed = self._ops[tenant].storage_bytes()
        self._ops.pop(tenant)
        fp = self._fingerprints.pop(tenant)
        self._plan_keys.pop(tenant, None)
        self.stats.evictions += 1
        self.stats.evicted_bytes += freed
        if fp not in self._fingerprints.values():
            self._artifacts.pop(fp, None)
            for key in [k for k in self._plans if k[0] == fp]:
                del self._plans[key]
        if obs.enabled():
            reg = obs.current_registry()
            reg.counter("fleet/evictions").inc()
            reg.counter("fleet/evicted_bytes").inc(float(freed))
            reg.gauge("fleet/tenants").set(len(self._ops))

    # -- fault tolerance ---------------------------------------------------
    @property
    def failed_devices(self) -> List[int]:
        return sorted(self._failed)

    def live_devices(self) -> List[torch.device]:
        """The positions of ``devices`` not lost, in order."""
        devices = self._devices
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        return [torch.device(d) for i, d in enumerate(devices)
                if i not in self._failed]

    def handle_device_loss(self, failed: Sequence[int]) -> List[str]:
        """Re-deal every mesh tenant over the survivors of ``failed``
        (positions in ``devices``) and swap the shrunken plans in.
        Single-device tenants are untouched. Returns the re-dealt tenants.
        Cached plans over the old positions are dropped, so a returning
        tenant is never handed a mesh with a lost position."""
        self._failed.update(int(i) for i in failed)
        survivors = self.live_devices()
        if not survivors:
            raise RuntimeError("no surviving devices")
        self.stats.device_losses += 1
        reg = obs.current_registry() if obs.enabled() else None
        if reg is not None:
            reg.counter("fleet/device_losses").inc()
        redone: List[str] = []
        shrunk: Dict[int, RealizedPlan] = {}   # id(old plan) -> new plan
        for tenant, op in self._ops.items():
            if (op.spec.num_devices or 1) <= 1:
                continue
            # tenants that shared a cached plan keep sharing after the
            # loss: the first pays the re-deal, the rest swap it in
            old_id = id(op.plan)
            prior = shrunk.get(old_id)
            t0 = time.perf_counter()
            plan = (op.swap(prior) if prior is not None
                    else op.shrink_to(survivors))
            dt = time.perf_counter() - t0
            shrunk[old_id] = plan
            # refreshed under the tenant's registration key: a returning
            # tenant asking for the pre-loss knobs gets the survivors' plan
            self._plans[self._plan_keys[tenant]] = plan
            redone.append(tenant)
            if reg is not None:
                reg.histogram("fleet/redeal_s",
                              {"tenant": tenant}).observe(dt)
        # drop every cached plan not refreshed above: its mesh may hold a
        # lost position (identity check: a plan holds tensors, so == would
        # compare them elementwise)
        live = {id(op.plan) for op in self._ops.values()}
        for key in [k for k, p in self._plans.items()
                    if id(p) not in live]:
            del self._plans[key]
        return redone

    def observe_flush(self, tenant: str, dt: float) -> bool:
        """Feed one flush latency to the straggler monitor; a flagged
        flush lands in ``fleet/straggler_flags``."""
        self._flush_seq += 1
        slow = self.monitor.observe(self._flush_seq, dt)
        if slow and obs.enabled():
            obs.current_registry().counter(
                "fleet/straggler_flags", {"tenant": tenant}).inc()
        return slow


__all__ = ["Fleet", "FleetStats"]
