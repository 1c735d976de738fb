"""SpMV, fleet and LM serving — the port of ``repro.launch.serve``.

Queued single-vector ``A @ x`` requests aggregate into one SpMM per flush
(matrix stream amortized over the batch), measured against serving them
one by one, all through one ``repro_torch.spmm.SparseOperator``:

  PYTHONPATH=src python -m repro_torch.launch.serve --mode spmv \\
      --matrix hhh_like --scale 64 --requests 256 --max-batch 32 \\
      --algorithm sellcs

Online migration — ``--migrate auto`` starts in the zero-conversion
merge-path CSR format, counts served multiplies, and converts to the
SELL-C-σ target plan in a background thread once the live break-even
estimate clears the projected remaining traffic; ``force`` converts
unconditionally (still off the flush path); ``off`` (default) pins the
start format. ``--metrics out.json`` dumps a ``repro.obs/v1`` document
with per-flush phase spans, p50/p95/p99 flush latency, the migration
decision inputs (``serve/multiplies_total``, ``serve/breakeven_estimate``,
``serve/plan_swaps``, ``serve/convert_s``, ...) and one observed-vs-
modeled residual record per flush. Headline timings are min-of-N
(``--reps``).

Mesh serving — ``--devices P`` answers each flush with a distributed SpMM
over a P-device mesh (``repro_torch.spmm.distributed``); the schedule and
the merge-sum chunk depth come from ``core.select_distributed``
(``--chunks c`` pins the depth). ``--mesh Pd,Pm`` pins a 2-D (data, model)
factorization whose model axis splits the X/Y columns. ``--compact-x on``
partitions with per-shard column compaction; ``--gather
upfront|overlap|fused`` schedules its X gather (fused = K8). The mesh
takes the machine's first P cards unless ``--mesh-devices`` names them; a
list may repeat one device, which runs every shard on it:

  PYTHONPATH=src python -m repro_torch.launch.serve --mode spmv \
      --matrix hhh_like --scale 64 --requests 256 --max-batch 32 \
      --devices 4 --mesh-devices cuda:0,cuda:0,cuda:0,cuda:0 \
      --compact-x on --gather fused

Runs on ``--device cuda`` (default; with ``--mesh-devices`` the default
is the first position's device) with the CUDA kernels; ``--device cpu``
runs the same path on the CPU (``--impl plain`` for the kernels' plain
versions, ``ref``/``auto`` for the oracles; a mesh then needs
``--mesh-devices cpu,cpu,...``).

Fleet mode — ``--mode fleet --tenants N`` serves N tenants from one
process through a ``repro_torch.spmm.Fleet`` (fingerprint-keyed plan
cache: the tenants cycle over two matrices, so the third is a cache hit
that pays no conversion or partition) fronted by a
``repro_torch.spmm.FleetBatcher`` (one queue per tenant; each flush goes
to the lane with the highest SLO urgency × batch efficiency under
``--slo-ms``). One device serves each tenant through K1; ``--devices P``
partitions each over P mesh positions (K8 with ``--compact-x on --gather
fused``). ``--fail-device auto`` loses the last position halfway through
the stream: every mesh tenant's width-row stream is re-dealt over the
survivors (no conversion) and serving goes on. Every answer, before and
after the loss, is held against the torch COO oracle of its tenant's
matrix; a miss raises:

  PYTHONPATH=src python -m repro_torch.launch.serve --mode fleet \
      --matrix road_like --scale 8 --tenants 3 --max-batch 32 \
      --requests 192 --devices 4 --mesh-devices \
      cuda:0,cuda:0,cuda:0,cuda:0 --compact-x on --gather fused \
      --fail-device auto --metrics fleet.json

  PYTHONPATH=src python -m repro_torch.launch.serve --mode fleet \
      --tenants 3 --devices 4 --mesh-devices cpu,cpu,cpu,cpu \
      --fail-device auto --scale 0.02 --impl plain

LM mode — batched prefill + greedy decode with KV caches, random weights
from ``--seed``, the port of ``repro.launch.serve``'s LM branch. The MoE
layers multiply through the grouped-GEMM kernel K9 (``--impl auto`` or
``kernel`` on the card; ``plain`` = its plain PyTorch version; ``ref`` =
the per-expert product, the reference's ``ragged_dot`` route, which
``auto`` takes on the CPU):

  PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \
      --arch granite-moe-1b-a400m --batch 32 --prompt-len 128 --gen 16

  PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \
      --arch granite-moe-1b-a400m --reduced --device cpu --impl plain
"""
from __future__ import annotations

import argparse
import math
import threading
import time

import numpy as np
import torch


class _MigrationController:
    """The online break-even loop — the paper's "472 multiplications" §7
    economics as a live control law over the serving traffic. Between
    flushes it counts served multiplies, re-scores the target with the
    live ``ResidualLedger`` (``select_distributed(feedback=)``), keeps the
    break-even estimate ``convert_cost_s / per-multiply saving``, starts
    the target build in a background thread when the projected remaining
    traffic clears it (``force`` skips the test), and installs a finished
    build through ``SparseOperator.swap`` between flushes."""

    def __init__(self, op, stats, args, target_spec, ledger, reg=None):
        from repro_torch.core.selector import (DEFAULT_CONVERSION_COST,
                                               DEFAULT_THROUGHPUT,
                                               DENSITY_THRESHOLD,
                                               ZERO_CONVERSION_ALGO,
                                               _augment_sellcs,
                                               break_even_spmvs)
        self.op = op
        self.stats = stats
        self.mode = args.migrate
        self.max_batch = int(args.max_batch)
        self.projected_total = int(args.requests)
        self.target_spec = target_spec
        self.ledger = ledger
        self.reg = reg
        self.multiplies = 0
        self.swapped = False
        self.swap_unix_s = None
        self.swap_at_multiply = None
        self.convert_s = None
        self.error = None
        self._min_per_mul = math.inf
        self._last_saving = None
        self._target_choice = None
        self._worker = None
        self._pending = None
        low = stats.density < DENSITY_THRESHOLD
        numa = (target_spec.num_devices or 1) > 1
        self._thr, self._conv = _augment_sellcs(
            dict(DEFAULT_THROUGHPUT[(numa, low)]),
            dict(DEFAULT_CONVERSION_COST), stats)
        self.breakeven = break_even_spmvs(
            "sellcs", baseline=ZERO_CONVERSION_ALGO, numa_like=numa,
            low_density=low, throughput=self._thr,
            conversion_cost={**self._conv, ZERO_CONVERSION_ALGO: 0.0})
        self._publish()

    def note_flush(self, k, dt, rp):
        """Called after every flush (k served columns in dt seconds on
        plan ``rp``)."""
        k = int(k)
        self.multiplies += k
        if self.reg is not None:
            self.reg.counter("serve/multiplies_total").inc(k)
        if self.mode == "off" or self.error is not None:
            return
        if not self.swapped:
            self._min_per_mul = min(self._min_per_mul, dt / max(k, 1))
            self._update_estimate(rp)
            remaining = self.projected_total - self.multiplies
            if self._worker is None and (self.mode == "force"
                                         or remaining > self.breakeven):
                self._start_build()
        self._install_pending()
        self._publish()

    def finish(self):
        """End of the traffic: join and install a build still in flight,
        and surface a background failure here."""
        if self._worker is not None:
            self._worker.join()
        self._install_pending()
        self._publish()
        if self.error is not None:
            raise self.error

    def _update_estimate(self, rp):
        if not math.isfinite(self._min_per_mul):
            return
        from repro_torch.core.selector import (_matrix_bytes_est,
                                               select_distributed)
        from repro_torch.obs import choice_labels
        from repro_torch.roofline import spmm_distributed_time
        st, kb = self.stats, self.max_batch
        # the current plan's measured touched-column mean (None without a
        # compact plan) replaces the nnz-proportional bound of the score
        nt = rp.n_touched
        ch = select_distributed(st, k=kb,
                                num_spmvs=max(self.projected_total, 1),
                                spec=self.target_spec, feedback=self.ledger,
                                n_touched=nt)
        self._target_choice = ch
        pd, pm = ch.mesh_shape
        gx = ch.gather if ch.compact_x else "upfront"
        t_model = spmm_distributed_time(
            st.m, st.n, kb, pd, ch.schedule,
            matrix_bytes=_matrix_bytes_est(ch.algorithm, st),
            max_row_nnz=st.max_row_nnz, num_chunks=ch.num_chunks,
            model_devices=pm, compact_x=ch.compact_x, nnz=st.nnz,
            n_touched=nt if ch.compact_x else None, gather=gx)
        t_corr = self.ledger.correction(**choice_labels(
            schedule=ch.schedule, num_chunks=ch.num_chunks,
            mesh_shape=ch.mesh_shape, compact_x=ch.compact_x,
            gather=gx if ch.compact_x else None))
        c_model = rp.model_s(kb) * self.ledger.correction(**rp.labels())
        per_now = self._min_per_mul
        per_target = per_now * (t_model * t_corr) / max(c_model, 1e-30)
        saving = per_now - per_target
        self._last_saving = saving
        if saving <= 0:
            self.breakeven = math.inf
            return
        convert_s = self.convert_s
        if convert_s is None:
            cur = rp.spec.algorithm or "merge"
            per_parcrs = per_now * (
                self._thr.get(cur, self._thr["parcrs"])
                / self._thr["parcrs"])
            convert_s = self._conv["sellcs"] * per_parcrs
        self.breakeven = convert_s / saving

    def _start_build(self):
        from repro_torch.core import PlanSpec
        ch = self._target_choice
        spec = self.target_spec if ch is None else PlanSpec(
            num_devices=ch.mesh_shape[0] * ch.mesh_shape[1],
            mesh_shape=ch.mesh_shape, num_chunks=ch.num_chunks,
            compact_x=ch.compact_x, schedule=ch.schedule,
            algorithm=ch.algorithm,
            gather=ch.gather if ch.compact_x else None)

        def build():
            try:
                t0 = time.perf_counter()
                rp = self.op.realize(spec)
                self.convert_s = time.perf_counter() - t0
                self._pending = rp
            except BaseException as e:       # surfaced in finish()
                self.error = e

        self._worker = threading.Thread(target=build, name="serve-migrate",
                                        daemon=True)
        self._worker.start()

    def _install_pending(self):
        rp = self._pending
        if rp is None:
            return
        self._pending = None
        self.op.swap(rp)
        self.swapped = True
        self.swap_unix_s = self.op.stats.last_swap_unix_s
        self.swap_at_multiply = self.multiplies
        if self.convert_s is not None and self._last_saving is not None \
                and self._last_saving > 0:
            self.breakeven = self.convert_s / self._last_saving
        if self.reg is not None:
            self.reg.counter("serve/plan_swaps").inc()
            self.reg.gauge("serve/swap_unix_s").set(float(self.swap_unix_s))
            self.reg.gauge("serve/swap_at_multiply").set(
                float(self.swap_at_multiply))
            if self.convert_s is not None:
                self.reg.gauge("serve/convert_s").set(float(self.convert_s))
        conv_ms = (self.convert_s or 0.0) * 1e3
        print(f"[serve-spmv] migrated to {rp.label} after "
              f"{self.swap_at_multiply} multiplies (convert "
              f"{conv_ms:.1f} ms in background, break-even "
              f"~{self.breakeven:.3g} multiplies)")

    def _publish(self):
        if self.reg is not None:
            self.reg.gauge("serve/breakeven_estimate").set(
                float(self.breakeven))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _serving_pass(op, xs, args, reg=None, controller=None):
    """The flush-by-flush serving loop: per-flush wall times into
    ``serve/flush_s`` (split pre/post-migration when a controller runs),
    one residual record per flush against the roofline prediction of the
    plan that served it, and the migration controller's hook."""
    from repro_torch.spmm import RequestBatcher

    batcher = RequestBatcher(op, max_batch=args.max_batch, impl=args.impl,
                             spmm_fn=lambda _m, X: op.matmul(X))
    for x in xs:
        batcher.submit(x)
    ledger = reg.ledger if reg is not None else (
        controller.ledger if controller is not None else None)
    while batcher.pending:
        rp = op.plan        # one read: the plan this flush executes on
        k = min(batcher.pending, args.max_batch)
        t0 = time.perf_counter()
        batcher.flush()
        _sync(op.device)
        dt = time.perf_counter() - t0
        if reg is not None:
            reg.histogram("serve/flush_s").observe(dt)
            if controller is not None:
                phase = ("serve/flush_postmigrate_s" if controller.swapped
                         else "serve/flush_premigrate_s")
                reg.histogram(phase).observe(dt)
        if ledger is not None:
            ledger.record("serve/flush", dt, rp.model_s(k), k=k,
                          **rp.labels(matrix=args.matrix, algo=rp.label,
                                      backend=op.device.type))
        if controller is not None:
            controller.note_flush(k, dt, rp)
    if controller is not None:
        controller.finish()


def _print_metrics_summary(reg):
    flush = reg.histogram("serve/flush_s")
    if flush.count:
        p = flush.percentiles()
        print(f"[serve-spmv] flush latency over {flush.count} flushes: "
              f"p50 {p['p50']*1e3:.2f} ms, p95 {p['p95']*1e3:.2f} ms, "
              f"p99 {p['p99']*1e3:.2f} ms"
              f"{' (exact)' if flush.exact else ''}")
    phases = [h for h in reg.histograms()
              if h.count and (h.name.startswith("spmm/")
                              or h.name.startswith("batcher/"))]
    for h in sorted(phases, key=lambda h: h.name):
        print(f"[serve-spmv]   phase {h.name:<24} n={h.count:<4} "
              f"mean {h.mean*1e3:8.3f} ms  p95 "
              f"{h.quantile(0.95)*1e3:8.3f} ms")
    ledger = reg.ledger
    if len(ledger):
        print(f"[serve-spmv] residual (observed/modeled) over "
              f"{len(ledger)} flushes: geomean {ledger.correction():.3g}")


def serve_spmv(args):
    """Batched (one SpMM per flush) vs sequential serving through one
    :class:`repro_torch.spmm.SparseOperator`, optionally migrating online
    from merge-path CSR to SELL-C-σ. Returns a dict with the headline
    times (``t_batched``, ``t_seq``), the initial plan's conversion
    seconds (``build_s``), the operator, the request vectors
    (``xs``), the batched answers (``answers``: rid -> y) and their ticket
    order (``rids``)."""
    from repro_torch import obs
    from repro_torch.core import PlanSpec, matrix_stats, spmv
    from repro_torch.core.selector import ZERO_CONVERSION_ALGO
    from repro_torch.data import matrices
    from repro_torch.roofline import spmm_arithmetic_intensity
    from repro_torch.spmm import RequestBatcher, SparseOperator

    suite = matrices.test_suite(scale=args.scale)
    if args.matrix not in suite:
        raise SystemExit(f"--matrix must be one of {sorted(suite)}")
    mesh_shape, mesh_devices = _mesh_positions(args)
    device = _serve_device(args)
    if args.devices > 1:
        if args.algorithm and args.algorithm != "sellcs":
            raise SystemExit(
                f"--algorithm {args.algorithm} cannot be served on a mesh: "
                "the --devices path multiplies the SELL-C-σ slice stream "
                "(repro_torch.spmm.distributed); drop --algorithm or pass "
                "sellcs")
    if args.migrate != "off" and args.algorithm:
        raise SystemExit(
            "--algorithm pins the format, --migrate lets the break-even "
            "economics choose it; drop one of the two")
    coo = matrices.as_coo(suite[args.matrix].make(), device=device)
    stats = matrix_stats(coo)
    num_spmms = -(-args.requests // args.max_batch)

    # the target the migration converts TO (and what --migrate off serves
    # directly)
    target_spec = _fleet_target_spec(args, mesh_shape)
    if args.migrate != "off":
        initial_spec = PlanSpec(num_devices=1,
                                algorithm=ZERO_CONVERSION_ALGO)
    elif args.devices > 1:
        initial_spec = target_spec
    else:
        initial_spec = PlanSpec(num_devices=1, algorithm=args.algorithm)

    op = SparseOperator.from_coo(coo, initial_spec, impl=args.impl,
                                 k_hint=args.max_batch,
                                 num_spmvs=num_spmms, devices=mesh_devices)
    algo, build_s = op.plan.label, op.plan.build_s
    print(f"[serve-spmv] matrix={args.matrix} m={stats.m} n={stats.n} "
          f"nnz={stats.nnz} algo={algo} (built in {build_s:.3f} s) "
          f"max_batch={args.max_batch} device={device}"
          + (f" migrate={args.migrate}" if args.migrate != "off" else ""))

    rng = np.random.default_rng(args.seed)
    xs = [torch.from_numpy(rng.standard_normal(stats.n).astype(np.float32)
                           ).to(device) for _ in range(args.requests)]

    reg = None
    if args.metrics:
        reg = obs.install(obs.MetricRegistry(
            backend=device.type, mode="spmv", matrix=args.matrix, algo=algo,
            devices=args.devices, max_batch=args.max_batch,
            migrate=args.migrate,
            requests=args.requests))
    controller = None
    if args.migrate != "off":
        ledger = reg.ledger if reg is not None else obs.ResidualLedger()
        controller = _MigrationController(op, stats, args, target_spec,
                                          ledger, reg=reg)

    def batched_run():
        b = RequestBatcher(op, max_batch=args.max_batch, impl=args.impl,
                           spmm_fn=lambda _m, X: op.matmul(X))
        rids = [b.submit(x) for x in xs]
        return b.drain(), rids, b.flushes

    t_b = obs.time_min_of_n(batched_run, reps=args.reps, warmup=1)
    out, rids, num_flushes = t_b.last_result
    t_batched = t_b.best_s

    t_s = obs.time_min_of_n(
        lambda: [spmv(op.plan.single, x, impl=op.plan.impl) for x in xs],
        reps=args.reps, warmup=1)
    seq, t_seq = t_s.last_result, t_s.best_s

    for rid, y in zip(rids, seq):
        torch.testing.assert_close(out[rid], y.to(out[rid].dtype),
                                   rtol=2e-4, atol=2e-4)
    ai1 = spmm_arithmetic_intensity(stats.nnz, stats.m, stats.n, 1)
    aik = spmm_arithmetic_intensity(stats.nnz, stats.m, stats.n,
                                    args.max_batch)
    print(f"[serve-spmv] batched {t_batched*1e3:.1f} ms "
          f"({num_flushes} SpMM calls) vs sequential "
          f"{t_seq*1e3:.1f} ms ({len(xs)} SpMV calls) — "
          f"speedup {t_seq/max(t_batched, 1e-9):.2f}x "
          f"(min of {t_b.reps}, warmup {t_b.warmup})")
    print(f"[serve-spmv] modelled intensity {ai1:.3f} -> {aik:.3f} "
          f"flop/byte at k={args.max_batch}")
    _print_traffic_model(op.spec, op.plan.n_touched, stats, args)

    if reg is not None or controller is not None:
        _serving_pass(op, xs, args, reg=reg, controller=controller)
    if reg is not None:
        _print_metrics_summary(reg)
        reg.dump(args.metrics)
        print(f"[serve-spmv] metrics -> {args.metrics}")
        obs.uninstall()
    return {"t_batched": t_batched, "t_seq": t_seq, "build_s": build_s,
            "op": op, "xs": xs, "answers": out, "rids": rids}


def _print_traffic_model(sp, n_touched, stats, args):
    """The modelled per-device traffic of a mesh plan (nothing on one
    device): HBM and collective bytes per flush, the compact-gather
    saving, and the merge-sum pipelining."""
    if (sp.num_devices or 1) <= 1:
        return
    from repro_torch.roofline import (spmm_distributed_collective_s,
                                      spmm_distributed_gather_s,
                                      spmm_distributed_traffic)
    sched, chunks = sp.schedule, sp.num_chunks or 1
    compact = bool(sp.compact_x)
    gx = (sp.gather or "upfront") if compact else "upfront"
    pd, pm = sp.mesh_shape
    kw = dict(nnz=stats.nnz, max_row_nnz=stats.max_row_nnz,
              model_devices=pm)
    hbm, coll = spmm_distributed_traffic(
        stats.m, stats.n, args.max_batch, pd, sched, compact_x=compact,
        n_touched=n_touched, **kw)
    print(f"[serve-spmv] modelled per-device traffic: {hbm / 1e6:.2f} MB "
          f"HBM + {coll / 1e6:.2f} MB collective per flush "
          f"(mesh=({pd},{pm}), schedule={sched}, chunks={chunks}, "
          f"compact_x={'on' if compact else 'off'}"
          + (f", gather={gx}" if compact else "") + ")")
    if compact:
        hbm_rep, _ = spmm_distributed_traffic(
            stats.m, stats.n, args.max_batch, pd, sched, **kw)
        print(f"[serve-spmv] compact gather: mean n_touched "
              f"{n_touched:.0f} of n={stats.n} rows per shard — "
              f"{(hbm_rep - hbm) / 1e6:.2f} MB HBM saved vs "
              "replicated X per flush")
        up, here = (spmm_distributed_gather_s(
            stats.m, stats.n, args.max_batch, pd, sched, num_chunks=chunks,
            compact_x=True, n_touched=n_touched, gather=g, **kw)
            for g in ("upfront", gx))
        print(f"[serve-spmv] exposed gather_s: {up * 1e6:.2f} us up-front "
              f"-> {here * 1e6:.2f} us with gather={gx}")
    if sched == "merge":
        mono, over = (spmm_distributed_collective_s(
            stats.m, stats.n, args.max_batch, pd, sched, num_chunks=c, **kw)
            for c in (1, chunks))
        print(f"[serve-spmv] exposed collective_s: {mono * 1e6:.2f} us "
              f"monolithic -> {over * 1e6:.2f} us with {chunks} "
              "chunk(s) pipelined under the slice stream")


def _serve_device(args) -> torch.device:
    """``--device``, else the first ``--mesh-devices`` position's device,
    else cuda."""
    from repro_torch.core import resolve_device
    if args.device is None and args.mesh_devices:
        return resolve_device(args.mesh_devices.split(",")[0])
    return resolve_device(args.device)


def _mesh_positions(args):
    """The mesh shape ``--mesh`` pins (it overrides ``--devices``) and the
    ``--mesh-devices`` positions, checked against ``--devices``."""
    mesh_shape = None
    if args.mesh:
        from repro_torch.launch.mesh import parse_mesh_shape
        mesh_shape = parse_mesh_shape(args.mesh)
        args.devices = mesh_shape[0] * mesh_shape[1]
    mesh_devices = (args.mesh_devices.split(",") if args.mesh_devices
                    else None)
    if args.devices > 1:
        have = (len(mesh_devices) if mesh_devices is not None
                else torch.cuda.device_count())
        if have < args.devices:
            raise SystemExit(
                f"the mesh needs {args.devices} devices but "
                f"{'--mesh-devices names' if mesh_devices else 'the machine has'}"
                f" {have}; name them with --mesh-devices (a list may "
                "repeat one device, e.g. cuda:0,cuda:0,cuda:0,cuda:0)")
    return mesh_shape, mesh_devices


def _fleet_target_spec(args, mesh_shape):
    """SELL-C-σ over the requested mesh, ``--mesh`` / ``--chunks`` /
    ``--compact-x`` / ``--gather`` pinning knobs the selector would
    sweep; one device without ``--devices``. Every fleet tenant's spec,
    and the spmv mode's target."""
    from repro_torch.core import PlanSpec
    compact = {"auto": None, "on": True, "off": False}[args.compact_x]
    gather = None if args.gather == "auto" else args.gather
    if args.devices > 1:
        return PlanSpec(num_devices=args.devices,
                        mesh_shape=mesh_shape or (args.devices, 1),
                        num_chunks=args.chunks if args.chunks > 0 else None,
                        compact_x=compact, algorithm="sellcs",
                        gather=gather)
    return PlanSpec(num_devices=1, algorithm="sellcs")


def _sellcs_launches():
    """K1's and K8's launch counters (``spmm.kernels.sellcs_slots``)."""
    from repro_torch.spmm.kernels import sellcs_slots
    return {"K1": sellcs_slots.launches, "K8": sellcs_slots.fused_launches}


def serve_fleet(args) -> dict:
    """Multi-tenant serving with a device-loss re-deal: ``--tenants``
    tenants over a :class:`repro_torch.spmm.Fleet` (the tenants cycle over
    ``--matrix`` and a second matrix, so from the third on a registration
    is a plan-cache hit) fronted by a :class:`repro_torch.spmm.
    FleetBatcher`. ``--fail-device`` (a position of the mesh; ``auto`` =
    the last) is lost once half the requests are served: every mesh
    tenant is re-dealt over the survivors and serving goes on. Every
    answer is held against its tenant's COO oracle (rtol = atol = 2e-4);
    a miss raises.

    ``--max-pending`` bounds each lane: a submit that would pass it waits
    for a flush, which this single-threaded loop runs first (the scheduler's
    pick), so nothing blocks forever. Flush latency (synchronized on the
    card) lands in ``fleet/flush_s``, split ``fleet/flush_preloss_s`` /
    ``fleet/flush_postloss_s`` around the loss, and the re-deal in
    ``fleet/redeal_s``. Returns the answers and sent vectors per
    ``(tenant, rid)``, the fleet, the front end, the re-deal seconds, the
    K1/K8 launches per tenant and phase, and the run's seconds."""
    from repro_torch import obs
    from repro_torch.data import matrices
    from repro_torch.spmm import Fleet, FleetBatcher, spmm_coo

    t_run = time.perf_counter()
    if args.tenants < 1:
        raise SystemExit("--tenants must be >= 1")
    suite = matrices.test_suite(scale=args.scale)
    if args.matrix not in suite:
        raise SystemExit(f"--matrix must be one of {sorted(suite)}")
    # two distinct matrices cycled over the tenants: same-matrix tenants
    # hit the plan cache, the other matrix shows the fleet multiplexes
    # independent operators
    alt = "hhh_like" if args.matrix != "hhh_like" else "road_like"
    names = [args.matrix, alt]
    mesh_shape, mesh_devices = _mesh_positions(args)
    per_tenant = max(1, args.requests // args.tenants)
    fail_device = None
    if args.fail_device is not None:
        if args.devices <= 1:
            raise SystemExit("--fail-device needs a --devices mesh")
        fail_device = (args.devices - 1 if args.fail_device == "auto"
                       else int(args.fail_device))
        if not 0 <= fail_device < args.devices:
            raise SystemExit(f"--fail-device must be a mesh position in "
                             f"0..{args.devices - 1}")
    device = _serve_device(args)
    positions = mesh_devices or [torch.device("cuda", i)
                                 for i in range(args.devices)]

    reg = None
    if args.metrics:
        reg = obs.install(obs.MetricRegistry(
            backend=device.type, mode="fleet", matrix=args.matrix,
            devices=args.devices, max_batch=args.max_batch,
            tenants=args.tenants, slo_ms=args.slo_ms, requests=per_tenant,
            fail_device="" if fail_device is None else fail_device))

    spec = _fleet_target_spec(args, mesh_shape)
    fleet = Fleet(impl=args.impl, devices=positions[:args.devices])
    front = FleetBatcher()
    coos = {}
    for i in range(args.tenants):
        tenant = f"t{i}"
        coos[tenant] = matrices.as_coo(suite[names[i % len(names)]].make(),
                                       device=device)
        t0 = time.perf_counter()
        op = fleet.register(tenant, coos[tenant], spec,
                            k_hint=args.max_batch,
                            num_spmvs=-(-per_tenant // args.max_batch))
        front.add_tenant(tenant, op, max_batch=args.max_batch,
                         slo_s=args.slo_ms / 1e3,
                         max_pending=args.max_pending or None,
                         overflow="block")
        print(f"[serve-fleet] {tenant}: {names[i % len(names)]} "
              f"m={op.shape[0]} plan={op.plan.label} registered in "
              f"{time.perf_counter() - t0:.3f} s, builds="
              f"(sellcs={op.stats.sellcs_builds}, "
              f"partition={op.stats.partition_builds})")
    print(f"[serve-fleet] plan cache: {fleet.stats.plan_cache_hits} hits, "
          f"{fleet.stats.plan_cache_misses} misses over "
          f"{fleet.stats.registered} registrations")

    rng = np.random.default_rng(args.seed)
    total = per_tenant * args.tenants
    state = {"served": 0, "lost": False, "redeal_s": None}
    results = {}                             # (tenant, rid) -> y
    launches = {}                            # (tenant, phase) -> counts

    def flush_one():
        if (fail_device is not None and not state["lost"]
                and state["served"] >= total // 2):
            t0 = time.perf_counter()
            redone = fleet.handle_device_loss([fail_device])
            _sync(device)
            state["redeal_s"] = time.perf_counter() - t0
            state["lost"] = True
            print(f"[serve-fleet] position {fail_device} lost after "
                  f"{state['served']}/{total} served: re-dealt "
                  f"{len(redone)} tenant plan(s) over "
                  f"{args.devices - 1} survivors in "
                  f"{state['redeal_s'] * 1e3:.1f} ms")
        before = _sellcs_launches()
        t0 = time.perf_counter()
        tenant, out = front.flush_next()
        _sync(device)
        dt = time.perf_counter() - t0
        phase = "postloss" if state["lost"] else "preloss"
        acc = launches.setdefault((tenant, phase), {"K1": 0, "K8": 0})
        for key, v in _sellcs_launches().items():
            acc[key] += v - before[key]
        state["served"] += len(out)
        for rid, y in out.items():
            results[(tenant, rid)] = y
        fleet.observe_flush(tenant, dt)
        if reg is not None:
            lab = {"tenant": tenant}
            reg.histogram("fleet/flush_s", lab).observe(dt)
            reg.histogram(f"fleet/flush_{phase}_s", lab).observe(dt)

    sent = {}                                # (tenant, rid) -> x
    for _ in range(per_tenant):
        for i in range(args.tenants):
            tenant = f"t{i}"
            x = torch.from_numpy(rng.standard_normal(
                coos[tenant].shape[1]).astype(np.float32)).to(device)
            while (args.max_pending
                   and front.lane(tenant).batcher.pending
                   >= args.max_pending):
                flush_one()
            sent[(tenant, front.submit(tenant, x))] = x
    while front.total_pending:
        flush_one()

    # the no-drop and correctness contract: every queued request answered,
    # every answer equal to its tenant's COO oracle, after the loss too
    if len(results) != total:
        raise AssertionError(f"served {len(results)} of {total} requests")
    for tenant, coo in coos.items():
        keys = [key for key in sent if key[0] == tenant]
        for j in range(0, len(keys), args.max_batch):
            chunk = keys[j:j + args.max_batch]
            want = spmm_coo(coo, torch.stack([sent[key] for key in chunk],
                                             dim=1))
            got = torch.stack([results[key] for key in chunk], dim=1)
            torch.testing.assert_close(got, want.to(got.dtype), rtol=2e-4,
                                       atol=2e-4)
    print(f"[serve-fleet] {total} requests served across "
          f"{args.tenants} tenants, all oracle-checked"
          + (" (incl. post-loss traffic)" if state["lost"] else ""))

    for i in range(args.tenants):
        tenant = f"t{i}"
        lane = front.lane(tenant)
        line = (f"[serve-fleet] {tenant}: served={lane.served} "
                f"flushes={lane.flushes} "
                f"slo_violations={lane.slo_violations} launches "
                + ", ".join(f"{ph} " + " ".join(
                    f"{k}={v}" for k, v in launches[(tenant, ph)].items())
                    for ph in ("preloss", "postloss")
                    if (tenant, ph) in launches))
        if reg is not None:
            for name in ("fleet/flush_s", "fleet/flush_preloss_s",
                         "fleet/flush_postloss_s"):
                h = reg.histogram(name, {"tenant": tenant})
                if h.count and (state["lost"] or name == "fleet/flush_s"):
                    p = h.percentiles()
                    line += (f" | {name[6:]} p50 {p['p50'] * 1e3:.2f} ms "
                             f"p95 {p['p95'] * 1e3:.2f} ms "
                             f"p99 {p['p99'] * 1e3:.2f} ms")
        print(line)
    seconds = time.perf_counter() - t_run
    print(f"[serve-fleet] run {seconds:.2f} s")
    if reg is not None:
        reg.dump(args.metrics)
        print(f"[serve-fleet] metrics -> {args.metrics}")
        obs.uninstall()
    return {"answers": results, "sent": sent, "coos": coos,
            "fleet": fleet, "front": front, "redeal_s": state["redeal_s"],
            "launches": launches, "seconds": seconds}


def build_parser() -> argparse.ArgumentParser:
    from repro_torch.core.convert import ALGORITHM_SPECS
    ap = argparse.ArgumentParser(
        description="SpMV serving on one device or a mesh, or LM serving "
                    "(repro_torch port)")
    ap.add_argument("--mode", choices=("lm", "spmv", "fleet"), default="lm",
                    help="lm (default, as the reference's serve), spmv or "
                         "fleet")
    ap.add_argument("--matrix", default="mawi_like")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--scale", type=float, default=0.02)
    ap.add_argument("--algorithm", default=None,
                    choices=sorted(ALGORITHM_SPECS),
                    help="force a format (default: core.select with k)")
    ap.add_argument("--devices", type=int, default=1,
                    help="serve each flush with a distributed SpMM over a "
                         "1-D data mesh of this many devices (schedule "
                         "chosen by core.select_distributed)")
    ap.add_argument("--mesh", default=None, metavar="Pd,Pm",
                    help="pin a 2-D (data, model) mesh; the model axis "
                         "splits the X/Y columns (overrides --devices with "
                         "Pd*Pm)")
    ap.add_argument("--mesh-devices", default=None, dest="mesh_devices",
                    metavar="DEV,DEV,...",
                    help="the mesh's devices in order, e.g. "
                         "cuda:0,cuda:0,cuda:0,cuda:0 (may repeat one "
                         "device; default: the first cards)")
    ap.add_argument("--chunks", type=int, default=0,
                    help="pipeline the merge-schedule sum into this many "
                         "chunks (0 = pick by the roofline overlap model; "
                         "ignored by the row schedule)")
    ap.add_argument("--compact-x", default="auto",
                    choices=("auto", "on", "off"), dest="compact_x",
                    help="per-shard column compaction: each data shard "
                         "gathers only the X rows its nonzeros touch "
                         "(auto = the traffic model decides)")
    ap.add_argument("--gather", default="auto",
                    choices=("auto", "upfront", "overlap", "fused"),
                    help="compact-X gather schedule: up-front slab, per "
                         "merge span (overlap), or inside the kernel "
                         "(fused, K8); auto = the exposed-gather roofline "
                         "term picks")
    ap.add_argument("--impl", default="auto",
                    choices=("auto", "ref", "kernel", "plain"),
                    help="kernel = the CUDA kernels (CUDA only); plain = "
                         "their plain PyTorch versions; ref = the oracles "
                         "(lm: the per-expert MoE product); auto = kernel "
                         "on cuda, ref on cpu")
    ap.add_argument("--device", default=None,
                    help="device to serve on (cuda or cpu; default cuda, "
                         "or the first --mesh-devices position's device)")
    ap.add_argument("--migrate", default="off",
                    choices=("auto", "off", "force"),
                    help="online break-even format migration from "
                         "merge-path CSR to SELL-C-σ: when it pays (auto), "
                         "unconditionally (force), or never (off)")
    ap.add_argument("--metrics", default=None, metavar="OUT.json",
                    help="install a repro_torch.obs registry and dump it "
                         "here (repro.obs/v1)")
    ap.add_argument("--reps", type=int, default=5,
                    help="min-of-N repetitions for the headline timing")
    ap.add_argument("--seed", type=int, default=0)
    # fleet-mode arguments
    ap.add_argument("--tenants", type=int, default=3,
                    help="fleet mode: number of tenants; they cycle over "
                         "two matrices, so >= 3 tenants hit the plan cache")
    ap.add_argument("--slo-ms", type=float, default=50.0, dest="slo_ms",
                    help="fleet mode: per-request latency budget of the "
                         "flush scheduler (urgency = oldest wait / budget)")
    ap.add_argument("--fail-device", default=None, dest="fail_device",
                    help="fleet mode: lose this mesh position halfway "
                         "through the stream ('auto' = the last) and "
                         "re-deal its spans over the survivors")
    ap.add_argument("--max-pending", type=int, default=0,
                    dest="max_pending",
                    help="fleet mode: per-tenant queue bound (0 = "
                         "unbounded); a submit past it waits for a flush")
    # lm-mode arguments
    ap.add_argument("--arch", default=None,
                    help="lm mode: architecture id (repro_torch.configs)")
    ap.add_argument("--reduced", action="store_true",
                    help="lm mode: the config's CPU test scale")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--n-layers", type=int, default=0, dest="n_layers",
                    help="lm mode: cut the depth to this many layers at "
                         "full width (0 = the config's own)")
    return ap


def serve_lm(args) -> dict:
    """Prefill ``--batch`` random prompts of ``--prompt-len`` tokens, then
    ``--gen`` - 1 greedy decode steps (argmax, the first index on ties).
    Returns the generated tokens [B, gen] and what a caller checks: the
    parameters, the prompts, the prefill logits, the config and the
    synchronized host times."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.device import resolve_device
    from repro_torch.models.model import decode_step, init_params, prefill

    if not args.arch:
        raise SystemExit("--arch is required in lm mode")
    dev = resolve_device(args.device)
    impl = args.impl
    if impl == "auto":
        impl = "kernel" if dev.type == "cuda" else "ref"
    if impl == "kernel" and dev.type != "cuda":
        raise SystemExit("--impl kernel needs --device cuda; use --impl "
                         "plain for K9's plain version on the CPU")
    cfg = get_config(args.arch, reduced=args.reduced)
    cfg = dataclasses.replace(
        cfg, moe_use_kernel=impl in ("kernel", "plain"),
        moe_plain=impl == "plain",
        n_layers=args.n_layers or cfg.n_layers)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    params = init_params(torch.Generator(device=dev).manual_seed(args.seed),
                         cfg)
    n_params = cfg.param_count(params)
    B, P, G = args.batch, args.prompt_len, args.gen
    offset = cfg.vision_tokens if cfg.frontend == "vision" else 0
    S_max = P + G + offset
    rng = torch.Generator(device=dev).manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=rng, device=dev)
    vis = None
    if cfg.frontend == "vision":
        vis = torch.randn((B, cfg.vision_tokens, cfg.vision_dim),
                          generator=rng, device=dev)

    sync()
    t0 = time.perf_counter()
    logits, caches = prefill(params, cfg, prompts, S_max,
                             cache_dtype=torch.float32, vision_embeds=vis)
    sync()
    t_prefill = time.perf_counter() - t0
    prefill_logits = logits

    tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    out_tokens = [tok]
    t0 = time.perf_counter()
    for i in range(G - 1):
        pos = torch.full((B,), offset + P + i, dtype=torch.int32,
                         device=dev)
        logits, caches = decode_step(params, cfg, tok, caches, pos)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        out_tokens.append(tok)
    sync()
    t_decode = time.perf_counter() - t0

    gen = torch.cat(out_tokens, dim=1).cpu().numpy()
    tps = B * (G - 1) / max(t_decode, 1e-9)
    print(f"[serve] arch={cfg.name} batch={B} prompt={P} gen={G} "
          f"layers={cfg.n_layers} params={n_params} device={dev} "
          f"impl={impl}")
    print(f"[serve] prefill {t_prefill * 1e3:.1f} ms; decode "
          f"{t_decode * 1e3:.1f} ms ({tps:.1f} tok/s)")
    print(f"[serve] sample generations (first 2 rows): {gen[:2].tolist()}")
    if not ((gen >= 0) & (gen < cfg.vocab)).all():
        raise AssertionError("generated a token outside the vocabulary")
    return {"tokens": gen, "params": params, "n_params": n_params,
            "prompts": prompts, "prefill_logits": prefill_logits,
            "cfg": cfg, "S_max": S_max, "t_prefill": t_prefill,
            "t_decode": t_decode, "tok_per_s": tps}


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.mode == "lm":
        return serve_lm(args)
    if args.mode == "fleet":
        return serve_fleet(args)
    return serve_spmv(args)


if __name__ == "__main__":
    main()
