"""The port's LM mesh against the JAX package on the CPU: the sharding
rules (every parameter spec of all ten archs at full width on both
production meshes and both profiles, optimizer-state, cache and batch
specs, ``cell_config``), the expert-parallel MoE dispatch
(``moe_apply_ep`` with and without drops, ``moe_apply_ep_tp``, through
``ragged_dot``'s counterpart and K9's plain version), a reduced granite
forward under EP, ``train --mesh 2x2`` (losses and checkpoint), ``reshard``,
the op counter and one dry-run record.

The reference's mesh needs ``XLA_FLAGS=--xla_force_host_platform_
device_count=4`` before JAX starts, so one module-scoped subprocess
computes every answer that needs a mesh (the EP dispatches, the EP
forward, ``NamedSharding.shard_shape``) into an ``.npz``; the port runs
in-process on meshes that name the CPU four times. Specs need no mesh:
both packages' rules read a duck-typed one.

Tolerances: specs equal exactly; an EP output within ``rtol = 1e-5, atol
= 1e-5 * max(1, max|ref|)`` of the reference (float32 sums in another
order), its aux within 1e-6; the EP forward within ``1e-4 * max(1,
max|ref|)`` of the reference and of the port's one-device forward; the
mesh training's losses within 1e-5 relative of one device's.
"""
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.launch import shardings as JSH
from repro.launch import steps as JST
from repro.models import model as JM
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import constant_lr as jconstant_lr
from repro.roofline import hlo_parse

from repro_torch.checkpoint import checkpoint as TCK
from repro_torch.configs import ARCH_IDS, SHAPES, cells, get_config
from repro_torch.interop import lm_params_from_arrays
from repro_torch.launch import dryrun, shardings as TSH, steps as TST
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import at_coords, make_mesh, set_mesh
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models.layers import META_INIT
from repro_torch.optim import constant_lr, make_optimizer
from repro_torch.optim.adamw import leaves
from repro_torch.roofline import analysis as TRA
from repro_torch.roofline import op_count
from repro_torch.runtime import build_mesh, reshard
from torch_threads import two_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
REL = 1e-5


class FakeMesh:
    """Duck-typed mesh: only axis_names/devices.shape are consulted."""
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


MESHES = {"16x16": FakeMesh((16, 16), ("data", "model")),
          "2x16x16": FakeMesh((2, 16, 16), ("pod", "data", "model"))}


# ---------------------------------------------------------------------------
# the cases the reference subprocess computes
# ---------------------------------------------------------------------------
# (arch, mesh shape, dispatch): at each arch's reduced widths
EP_CASES = [(a, m, f) for a in ("granite-moe-1b-a400m", "mixtral-8x22b")
            for m in ((2, 2), (1, 4)) for f in ("ep", "ep_tp")]
DROP = ("drops", (2, 2), "ep")
SHARD_CASES = [((8, 12), ("data", "model")), ((8, 12), (None, "model")),
               ((4, 6, 8), ("model", None, "data")), ((6,), (None,)),
               ((8, 4), (("data", "model"), None))]


def _moe_inputs(case):
    """(MoE widths (d, f, E, k), params, x) of an EP case, from numpy."""
    arch, _, _ = case
    if arch == "drops":
        d, f, E, k, B, S = 64, 64, 8, 4, 4, 64
    else:
        c = get_config(arch, reduced=True)
        d, f, E, k, B, S = c.d_model, c.d_ff, c.n_experts, c.top_k, 4, 16
    r = np.random.default_rng(sum(map(ord, arch)) + 7 * len(case[1]))
    p = {"router": {"w": (r.standard_normal((d, E)) * d ** -0.5)},
         "w_gate": r.standard_normal((E, d, f)) * d ** -0.5,
         "w_up": r.standard_normal((E, d, f)) * d ** -0.5,
         "w_down": r.standard_normal((E, f, d)) * f ** -0.5}
    x = r.standard_normal((B, S, d))
    if arch == "drops":
        # every token's top-4 are experts 0-3, all on rank 0 of the
        # (2, 2) mesh's model axis: rank 0 drops past its capacity
        x[..., 0] = 4.0
        p["router"]["w"][0, :4] = 2.0
    p = {"router": {"w": p["router"]["w"].astype(np.float32)},
         **{k: v.astype(np.float32) for k, v in p.items() if k != "router"}}
    return (d, f, E, k), p, x.astype(np.float32)


def _key(case):
    return "/".join(str(v) for v in case)


def _fwd_inputs():
    """The EP forward's reduced granite tree (the reference's shapes,
    filled from numpy) and tokens."""
    jcfg = jget_config("granite-moe-1b-a400m", reduced=True)
    shapes = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    rng = np.random.default_rng(3)

    def leaf(path, s):
        if path[-1].key == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(
                np.float32)
        fan = jcfg.d_model if path[-1].key == "embed" else s.shape[-2]
        return (rng.standard_normal(s.shape) * fan ** -0.5).astype(
            np.float32)
    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    tokens = np.random.default_rng(4).integers(
        0, jcfg.vocab, (4, 16)).astype(np.int32)
    return tree, tokens


SUB = textwrap.dedent("""
    import sys, json, dataclasses
    import numpy as np, jax, jax.numpy as jnp
    sys.path.insert(0, {tests!r})
    import test_torch_lm_mesh as T
    from repro.compat import set_mesh
    from repro.configs import get_config
    from repro.launch.mesh import make_mesh
    from repro.models import model as JM, moe as JMOE
    from jax.sharding import NamedSharding, PartitionSpec as P
    out = {{}}
    for case in T.EP_CASES + [T.DROP]:
        (d, f, E, k), p, x = T._moe_inputs(case)
        cfg = JMOE.MoEConfig(d, f, E, k)
        mesh = make_mesh(case[1], ("data", "model"))
        fn = JMOE.moe_apply_ep if case[2] == "ep" else JMOE.moe_apply_ep_tp
        with set_mesh(mesh):
            y, aux = jax.jit(lambda p, x: fn(p, cfg, x))(p, x)
        out[T._key(case)] = np.asarray(y)
        out[T._key(case) + "/aux"] = np.asarray(aux)
        if case == T.DROP:
            y0, _ = JMOE.moe_apply(p, cfg, x)
            out["drops/base"] = np.asarray(y0)
    # the fsdp profile's EP: the batch split over the expert axis too
    (d, f, E, k), p, x = T._moe_inputs(T.EP_CASES[0])
    cfg = JMOE.MoEConfig(d, f, E, k)
    with set_mesh(make_mesh((2, 2), ("data", "model"))):
        y, aux = jax.jit(lambda p, x: JMOE.moe_apply_ep(
            p, cfg, x, batch_axes=("data", "model")))(p, x)
    out["fsdp_ep"], out["fsdp_ep/aux"] = np.asarray(y), np.asarray(aux)
    out["fsdp_ep/base"] = np.asarray(JMOE.moe_apply(p, cfg, x)[0])
    # the reduced granite forward under the cell's EP on (2, 2)
    tree, tokens = T._fwd_inputs()
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m",
                                         reduced=True),
                              batch_axes=("data",), moe_ep="ep")
    mesh = make_mesh((2, 2), ("data", "model"))
    with set_mesh(mesh):
        h, aux = jax.jit(lambda p, t: JM.forward(p, cfg, t))(tree, tokens)
    out["fwd/h"], out["fwd/aux"] = np.asarray(h), np.asarray(aux)
    # NamedSharding.shard_shape on a (2, 2) mesh
    for shape, spec in T.SHARD_CASES:
        ns = NamedSharding(mesh, P(*spec))
        out["shard" + str((shape, spec))] = np.asarray(ns.shard_shape(shape))
    np.savez({path!r}, **out)
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lm_mesh") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               + os.environ.get("XLA_FLAGS", ""))
    out = subprocess.run(
        [sys.executable, "-c", SUB.format(tests=str(ROOT / "tests"),
                                          path=path)],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(path))


def _close(got, want, rtol=REL, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol = rtol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


def _cpu_mesh(shape):
    return make_mesh(shape, ("data", "model"),
                     devices=[CPU] * int(np.prod(shape)))


# ---------------------------------------------------------------------------
# the sharding rules
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _ref_shapes(arch):
    """The reference's full-width parameter tree, as shapes."""
    return jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                 jget_config(arch)))


def _ref_specs(arch, mesh, profile):
    """{key path: spec} of the reference's full-width params."""
    shapes = _ref_shapes(arch)
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert all(TSH.path_str(p) == JSH.path_str(p) for p, _ in flat)
    return {JSH.path_str(p): JSH.param_spec_for(
        JSH.path_str(p), l.shape, mesh, "groups" in JSH.path_str(p), profile)
        for p, l in flat}, shapes


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch):
    """Every leaf of the full-width config, both production meshes, both
    profiles: the port's stacked leaf (``leaf_stacks``) has the
    reference's spec, and each layer tensor that spec without its leading
    None."""
    params = TM.init_params(META_INIT, get_config(arch))
    for mesh in MESHES.values():
        for profile in ("tp", "fsdp"):
            want, _ = _ref_specs(arch, mesh, profile)
            got = TSH.stacked_specs(params, mesh, profile)
            assert set(got) == set(want), set(got) ^ set(want)
            for k in want:
                assert tuple(got[k]) == tuple(want[k]), (arch, profile, k)
            per = iter(TSH.param_shardings(params, mesh, profile))
            for n, ts, st in params.leaf_stacks():
                spec = tuple(want[TSH.reference_key(n, st)])
                for _ in ts:
                    assert tuple(next(per).spec) == spec[1 if st else 0:], \
                        (arch, profile, n)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "jamba-1.5-large-398b"])
def test_opt_state_shardings_match_reference(arch, opt, monkeypatch):
    """Optimizer state specs by the reference's shape matching (the last
    leaf of a shape in its tree order wins): AdamW's per-layer moments
    take their stacked leaf's spec less the group entry, Adafactor's
    stacked factors the reference's."""
    monkeypatch.setattr(JSH, "NamedSharding", lambda mesh, spec: spec)
    mesh = MESHES["16x16"]
    _, shapes = _ref_specs(arch, mesh, "tp")
    jopt = jmake_optimizer(opt, jconstant_lr(1e-3))
    jstate = jax.eval_shape(jopt.init, shapes)
    want = JSH.opt_state_shardings(jstate, shapes, mesh)
    params = TM.init_params(META_INIT, get_config(arch))
    state = make_optimizer(opt, constant_lr(1e-3)).init(params)
    got = TSH.opt_state_shardings(state, params, mesh)
    assert tuple(got.step.spec) == tuple(want.step)
    stacks = [(TSH.reference_key(n, st), len(ts), st)
              for n, ts, st in params.leaf_stacks()]

    def ref_leaf(tree, key):
        node = tree
        for k in key.split("/"):
            node = node[int(k)] if isinstance(node, list) else node[k]
        return node
    if opt == "adamw":
        for field in ("m", "v"):
            i = 0
            for key, n, st in stacks:
                spec = tuple(ref_leaf(getattr(want, field), key))
                for _ in range(n):
                    assert tuple(getattr(got, field)[i].spec) == \
                        spec[1 if st else 0:], (field, key)
                    i += 1
    else:
        for field in ("vr", "vc"):
            for (key, _, _), sh in zip(stacks, getattr(got, field)):
                assert tuple(sh.spec) == tuple(
                    ref_leaf(getattr(want, field), key)), (field, key)


@pytest.mark.parametrize("arch,shape", [
    ("jamba-1.5-large-398b", "decode_32k"),
    ("jamba-1.5-large-398b", "long_500k"),
    ("llama3.2-1b", "decode_32k"), ("mamba2-1.3b", "long_500k")])
def test_cache_and_batch_shardings_match_reference(arch, shape,
                                                   monkeypatch):
    monkeypatch.setattr(JSH, "NamedSharding", lambda mesh, spec: spec)
    s = SHAPES[shape]
    for mesh in MESHES.values():
        jc = jax.eval_shape(lambda: JM.init_cache(jget_config(arch),
                                                  s.batch, s.seq))
        want = jax.tree_util.tree_leaves(
            JSH.cache_shardings(jc, mesh, s.batch),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        tc = TM.init_cache(get_config(arch), s.batch, s.seq,
                           device="meta")
        got = [sh for c in TSH.cache_shardings(tc, mesh, s.batch)
               for sh in c]
        assert [tuple(g.spec) for g in got] == [tuple(w) for w in want]
        assert tuple(TSH.batch_sharding(mesh, s.batch).spec) == tuple(
            JSH.batch_sharding(mesh, s.batch))


def test_cell_config_matches_reference():
    for mesh in MESHES.values():
        for arch, shape, _ in cells():
            for profile in ("tp", "fsdp", "fsdp_seqp"):
                a = JST.cell_config(arch, shape, mesh, profile)
                b = TST.cell_config(arch, shape, mesh, profile)
                assert (a.moe_ep, tuple(a.batch_axes), tuple(a.seq_axes),
                        a.seq_axes_size) == \
                    (b.moe_ep, tuple(b.batch_axes), tuple(b.seq_axes),
                     b.seq_axes_size), (arch, shape, profile)


# ---------------------------------------------------------------------------
# the expert-parallel dispatch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("case", EP_CASES + [DROP], ids=_key)
def test_ep_dispatch_matches_reference(ref, case, use_kernel):
    (d, f, E, k), p, x = _moe_inputs(case)
    cfg = TMOE.MoEConfig(d, f, E, k, use_kernel=use_kernel)
    tp = {"router": {"w": torch.from_numpy(p["router"]["w"])},
          **{n: torch.from_numpy(v) for n, v in p.items() if n != "router"}}
    with set_mesh(_cpu_mesh(case[1])):
        if case[2] == "ep":
            y, aux = TMOE.moe_apply_ep(tp, cfg, torch.from_numpy(x))
            dropped = TMOE.ep_dropped_slots(tp, cfg, torch.from_numpy(x))
        else:
            y, aux = TMOE.moe_apply_ep_tp(tp, cfg, torch.from_numpy(x))
    _close(y, ref[_key(case)], what=_key(case))
    assert abs(float(aux) - float(ref[_key(case) + "/aux"])) <= 1e-6
    if case == DROP:
        # it really drops: the reference's EP differs from its moe_apply
        # in every token row, and the port counts the dropped slots
        diff = np.abs(ref[_key(case)] - ref["drops/base"]).reshape(
            -1, d).max(1)
        assert (diff > 1e-3).all() and diff.max() > 0.5, diff
        assert dropped > 0


def test_ep_with_the_batch_over_the_expert_axis_mirrors_the_reference(ref):
    """The fsdp profile's cells split the batch over every axis, the
    expert axis too (``cell_config``); the reference's psum over that
    axis then adds other batch blocks' outputs to each block's, and its
    output is not its ``moe_apply``'s (a fault of the reference, kept:
    ROADMAP.md queue 3). The port's global dispatch gives the same
    answer; its mesh train step refuses the combination."""
    (d, f, E, k), p, x = _moe_inputs(EP_CASES[0])
    cfg = TMOE.MoEConfig(d, f, E, k)
    tp = {"router": {"w": torch.from_numpy(p["router"]["w"])},
          **{n: torch.from_numpy(v) for n, v in p.items() if n != "router"}}
    with set_mesh(_cpu_mesh((2, 2))):
        y, aux = TMOE.moe_apply_ep(tp, cfg, torch.from_numpy(x),
                                   batch_axes=("data", "model"))
        with at_coords({"data": 0, "model": 1}):
            with pytest.raises(NotImplementedError, match="carries the "
                               "batch"):
                TMOE.moe_apply_ep(tp, cfg, torch.from_numpy(x[:1]),
                                  batch_axes=("data", "model"))
    _close(y, ref["fsdp_ep"], what="fsdp EP")
    assert abs(float(aux) - float(ref["fsdp_ep/aux"])) <= 1e-6
    assert np.abs(ref["fsdp_ep"] - ref["fsdp_ep/base"]).max() > 0.5


def test_ep_dispatch_needs_a_mesh_and_divisible_axes():
    (d, f, E, k), p, x = _moe_inputs(EP_CASES[0])
    tp = {"router": {"w": torch.from_numpy(p["router"]["w"])},
          **{n: torch.from_numpy(v) for n, v in p.items() if n != "router"}}
    cfg = TMOE.MoEConfig(d, f, E, k)
    with pytest.raises(RuntimeError, match="ambient mesh"):
        TMOE.moe_apply_ep(tp, cfg, torch.from_numpy(x))
    with set_mesh(_cpu_mesh((1, 4))):
        with pytest.raises(ValueError, match="must divide"):
            TMOE.moe_apply_ep(tp, cfg._replace(n_experts=6),
                              torch.from_numpy(x))


def test_reduced_granite_forward_under_ep(ref):
    """The cell's EP (``_moe_mode``: experts divide the model axis) on
    (2, 2) against the reference's, and against the port's one-device
    forward (at this batch no slot is dropped)."""
    tree, tokens = _fwd_inputs()
    base = get_config("granite-moe-1b-a400m", reduced=True)
    mesh = _cpu_mesh((2, 2))
    cfg = dataclasses.replace(base, batch_axes=("data",))
    cfg = dataclasses.replace(cfg, moe_ep=TST._moe_mode(cfg, mesh))
    assert cfg.moe_ep == "ep"
    params = lm_params_from_arrays(tree, cfg, device=CPU)
    t = torch.from_numpy(tokens)
    with torch.no_grad():
        with set_mesh(mesh):
            h, aux = TM.forward(params, cfg, t)
        h1, aux1 = TM.forward(params, base, t)
    _close(h, ref["fwd/h"], rtol=1e-4, what="EP forward vs reference")
    assert abs(float(aux) - float(ref["fwd/aux"])) <= 1e-6
    _close(h, h1.numpy(), rtol=1e-4, what="EP forward vs one device")
    assert abs(float(aux) - float(aux1)) <= 1e-6


def test_constrain_batch_raises_where_jax_would():
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m",
                                         reduced=True), batch_axes=("data",))
    x = torch.zeros(3, 4, 8)
    with pytest.raises(RuntimeError, match="ambient mesh"):
        TM._constrain_batch(cfg, x)
    with set_mesh(_cpu_mesh((2, 2))):
        with pytest.raises(ValueError, match="not divisible"):
            TM._constrain_batch(cfg, x)
        assert TM._constrain_batch(cfg, torch.zeros(4, 4, 8)).shape[0] == 4
        with pytest.raises(ValueError, match="not in the mesh"):
            TM._constrain_batch(dataclasses.replace(cfg,
                                                    batch_axes=("pod",)), x)


# ---------------------------------------------------------------------------
# training on a mesh
# ---------------------------------------------------------------------------
TRAIN_ARGV = ["--arch", "granite-moe-1b-a400m", "--reduced", "--steps", "3",
              "--batch", "4", "--seq", "16", "--device", CPU]


def test_train_mesh_2x2_matches_1x1_and_checkpoints_whole(tmp_path):
    """3 steps of ``train --mesh 2x2`` on four CPU positions give the
    one-device losses; its last checkpoint restores into a one-device
    state leaf for leaf equal to the mesh state gathered, and a one-device
    run resumes from it as the mesh run does."""
    one = ttrain.main(TRAIN_ARGV + ["--save-every", "0"])
    d = str(tmp_path / "mesh")
    mesh = ttrain.main(TRAIN_ARGV + ["--mesh", "2x2", "--mesh-devices",
                                     ",".join([CPU] * 4), "--ckpt-dir", d,
                                     "--save-every", "3"])
    for a, b in zip(mesh["losses"], one["losses"]):
        assert abs(a - b) <= REL * abs(b), (mesh["losses"], one["losses"])
    assert TCK.latest_step(d) == 3
    cfg = get_config("granite-moe-1b-a400m", reduced=True)
    target = TM.init_params(torch.Generator().manual_seed(9), cfg)
    opt = make_optimizer("adamw", constant_lr(1e-3)).init(target)
    restored = TCK.restore(d, 3, TST.TrainState(target, opt))
    whole = TST.gather_train_state(mesh["state"], CPU)
    for a, b in zip(leaves(restored.params), leaves(whole.params)):
        assert torch.equal(a, b)
    for a, b in zip(restored.opt.m + restored.opt.v,
                    whole.opt.m + whole.opt.v):
        assert torch.equal(a, b)
    assert int(restored.opt.step) == int(whole.opt.step) == 3
    # resume one step further: on one device and on the mesh alike
    argv = TRAIN_ARGV[:4] + ["4"] + TRAIN_ARGV[5:] + ["--ckpt-dir", d,
                                                      "--resume", "auto",
                                                      "--save-every", "0"]
    r1 = ttrain.main(argv)
    rm = ttrain.main(argv + ["--mesh", "2x2", "--mesh-devices",
                             ",".join([CPU] * 4)])
    assert r1["start"] == rm["start"] == 3
    assert abs(r1["losses"][0] - rm["losses"][0]) <= REL * abs(
        r1["losses"][0])


def test_mesh_train_step_adafactor_and_grad_accum():
    """Adafactor (its factors span whole stacked leaves) and two
    microbatches on a (2, 1) mesh: one step equals one device's."""
    cfg = get_config("mamba2-1.3b", reduced=True)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (4, 16)).astype(np.int64))
    out = []
    for mesh in (None, _cpu_mesh((2, 1))):
        c = dataclasses.replace(cfg, batch_axes=("data",)) if mesh else cfg
        params = TM.init_params(torch.Generator().manual_seed(2), cfg)
        opt = make_optimizer("adafactor", constant_lr(1e-2))
        state = TST.TrainState(params, opt.init(params))
        if mesh is not None:
            state = TST.place_train_state(state, mesh)
        step = TST.make_train_step(c, opt, grad_accum=2, mesh=mesh)
        state, m = step(state, {"tokens": tokens})
        out.append((float(m["loss"]), TST.gather_train_state(state, CPU)))
    assert abs(out[0][0] - out[1][0]) <= REL * abs(out[0][0])
    for a, b in zip(leaves(out[0][1].params), leaves(out[1][1].params)):
        _close(b.detach(), a.detach(), what="params after one step")


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------
def test_build_mesh_and_reshard(ref):
    mesh = build_mesh((2, 2), ("data", "model"), [CPU] * 4)
    rng = np.random.default_rng(6)
    tree = {str(i): torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for i, (shape, _) in enumerate(SHARD_CASES)}
    specs = {str(i): spec for i, (_, spec) in enumerate(SHARD_CASES)}
    placed = reshard(tree, mesh, lambda key, leaf: TSH.P(*specs[key]))
    for i, (shape, spec) in enumerate(SHARD_CASES):
        st = placed[str(i)]
        want = tuple(ref["shard" + str((shape, spec))])
        assert st.sharding.shard_shape(shape) == want
        assert all(tuple(b.shape) == want for b in st.shards.values())
        assert torch.equal(st.gather(), tree[str(i)])
        # the union of the distinct blocks is the leaf, each once
        cover = torch.zeros(shape)
        for pos in st.distinct():
            cover[st.sharding.index(pos, shape)] += 1
        assert bool((cover == 1).all())
    again = reshard(placed, build_mesh((4, 1), ("data", "model"), [CPU] * 4),
                    lambda key, leaf: TSH.P("data") if key == "0"
                    else TSH.P())
    assert torch.equal(again["0"].gather(), tree["0"])
    with pytest.raises(ValueError, match=re.escape(
            "names axis 'pod', but the target mesh only has "
            "('data', 'model')")):
        reshard(tree, mesh, lambda key, leaf: TSH.P("pod"))
    with pytest.raises(ValueError, match="need 8 devices, have 4"):
        build_mesh((2, 4), ("data", "model"), [CPU] * 4)


# ---------------------------------------------------------------------------
# the op counter and the roofline
# ---------------------------------------------------------------------------
def _meta(*shape, grad=False):
    return torch.empty(shape, device="meta", requires_grad=grad)


def test_op_counter_loop_counts_every_pass():
    x, ws = _meta(128, 128), [_meta(128, 128) for _ in range(8)]
    with op_count.OpCounter() as c:
        h = x
        for w in ws:
            h = h @ w
    assert c.dot_flops == 8 * 2 * 128 ** 3
    assert c.ops["mm"] == 8


def test_op_counter_grad_flops_3x_forward():
    x, ws = _meta(128, 128), [_meta(128, 128, grad=True) for _ in range(8)]
    fwd = 8 * 2 * 128 ** 3
    with op_count.OpCounter() as c:
        h = x
        for w in ws:
            h = h @ w
        torch.autograd.grad((h ** 2).sum(), ws)
    assert 2.8 < c.dot_flops / fwd < 3.3


def test_op_counter_dot_with_batch_dims():
    with op_count.OpCounter() as c:
        torch.einsum("bij,bjk->bik", _meta(4, 64, 32), _meta(4, 32, 16))
    assert abs(c.dot_flops / (2 * 4 * 64 * 32 * 16) - 1) < 0.05


def test_op_counter_dot_flops_equal_hlo_parse():
    """A jitted matmul chain: the reference's parsed HLO and the port's
    counter give the same dot flops."""
    def chain(x, a, b, c):
        return x @ a @ b @ c
    specs = [jax.ShapeDtypeStruct(s, jnp.float32) for s in
             ((64, 96), (96, 128), (128, 32), (32, 48))]
    txt = jax.jit(chain).lower(*specs).compile().as_text()
    want = hlo_parse.analyze(txt)["flops"]
    got = op_count.analyze(chain, *[_meta(*s.shape) for s in specs])
    assert got["dot_flops"] == got["flops"] == want == 2 * (
        64 * 96 * 128 + 64 * 128 * 32 + 64 * 32 * 48)


def test_op_counter_equal_passes_count_every_pass():
    """On meta, ``equal_calls`` and ``equal_passes`` run the first pass
    alone; the counts, forward and backward (autograd's, after
    ``equal_calls``; in the pass, under ``equal_passes``), equal those of
    every pass run on the CPU."""
    def step(dev):
        a = torch.ones((4, 8, 16), device=dev, requires_grad=True)
        w = torch.ones((16, 32), device=dev, requires_grad=True)
        outs = op_count.equal_calls(lambda i, ai, wi: ((ai @ wi).tanh(),),
                                    list(range(4)), lambda i: (a[i], w))
        sum(o[0].sum() for o in outs).backward()
        for i in op_count.equal_passes(list(range(3)), a):
            torch.autograd.grad((a[i] * 2.0).sum(), a)

    counts = []
    for dev in ("cpu", "meta"):
        with op_count.OpCounter() as c:
            step(dev)
        counts.append(c)
    cpu, meta = counts
    assert meta.dot_flops == cpu.dot_flops == 3 * 4 * 2 * 8 * 16 * 32
    assert meta.ops["tanh"] == cpu.ops["tanh"] == 4
    assert meta.ops["mm"] == cpu.ops["mm"] == 12
    assert meta.ops["mul"] == cpu.ops["mul"]


def test_collectives_by_kind_and_roofline_terms():
    with op_count.OpCounter() as c:
        op_count.record_collective("all-gather", 256 * 16 * 4)
        op_count.record_collective("all-reduce", 128 * 2)
        with op_count.repeated(3):
            op_count.record_collective("reduce-scatter", 10)
    parsed = TRA.parse_collective_bytes(c)
    assert parsed["all-gather"] == {"bytes": 256 * 16 * 4, "count": 1}
    assert parsed["all-reduce"]["bytes"] == 128 * 2
    assert parsed["reduce-scatter"] == {"bytes": 30, "count": 3}
    assert parsed == TRA.parse_collective_bytes(
        [("all-gather", 256 * 16 * 4), ("all-reduce", 256)]
        + [("reduce-scatter", 10)] * 3)
    assert TRA.collective_bytes_total(parsed) == 256 * 16 * 4 + 2 * 256 + 30
    with pytest.raises(ValueError):
        op_count.record_collective("broadcast", 1)
    r = TRA.Roofline(flops_per_device=TRA.PEAK_FLOPS_BF16,
                     bytes_per_device=TRA.HBM_BW,
                     collective_bytes_per_device=0.0, chips=256,
                     model_flops=TRA.PEAK_FLOPS_BF16 * 256)
    assert abs(r.compute_s - 1.0) < 1e-9 and abs(r.memory_s - 1.0) < 1e-9
    assert r.bottleneck in ("compute", "memory")
    assert 0.99 < r.useful_flops_fraction < 1.01
    assert TRA.Roofline(1e12, 1e9, 1e12, 256).bottleneck == "collective"


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------
def _shard_bytes(shape, spec, mesh, itemsize):
    size = dict(zip(mesh.axis_names, mesh.devices.shape))
    n = 1
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        div = int(np.prod([size[a] for a in axes])) if axes else 1
        assert dim % div == 0
        n *= dim // div
    return n * itemsize


def test_dryrun_record_granite_train_4k(tmp_path, monkeypatch):
    """One cell on 256 meta positions: the record's keys, its per-device
    argument bytes equal to the shard bytes of the reference's rules
    (parameters, AdamW state and the token batch), and its counted flops
    x chips between the model's flops and twice them."""
    arch, shape = "granite-moe-1b-a400m", "train_4k"
    assert dryrun.main(["--arch", arch, "--shape", shape, "--out",
                        str(tmp_path)]) == 0
    rec = json.load(open(tmp_path / f"{arch}__{shape}__16_16.json"))
    for k in ("lower_s", "compile_s", "argument_size_in_bytes",
              "output_size_in_bytes", "hbm_bytes_per_device",
              "collectives", "roofline", "op_count_analysis"):
        assert k in rec, k
    assert rec["chips"] == 256 and rec["mesh"] == "16x16"
    # the reference's rules on its own tree shapes
    monkeypatch.setattr(JSH, "NamedSharding", lambda mesh, spec: spec)
    mesh = MESHES["16x16"]
    cfg = jget_config(arch)
    shapes = _ref_shapes(arch)
    specs = JSH.param_shardings(shapes, mesh)
    jopt = JST.default_optimizer(cfg)
    ostate = jax.eval_shape(jopt.init, shapes)
    ospecs = JSH.opt_state_shardings(ostate, shapes, mesh)
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)
    want = 0
    for tree, st in ((shapes, specs), (ostate, ospecs)):
        for leaf, spec in zip(jax.tree_util.tree_leaves(tree),
                              jax.tree_util.tree_leaves(st,
                                                        is_leaf=is_spec)):
            want += _shard_bytes(leaf.shape, spec, mesh,
                                 np.dtype(leaf.dtype).itemsize)
    s = SHAPES[shape]
    want += _shard_bytes((s.batch, s.seq), JSH.batch_sharding(mesh, s.batch),
                         mesh, 4)
    assert rec["argument_size_in_bytes"] == want
    mf = dryrun.model_flops_for(arch, shape)
    total = rec["roofline"]["flops_per_device"] * rec["chips"]
    assert mf <= total <= 2 * mf, (total / mf)
    assert rec["collectives"]["all-reduce"]["count"] > 0       # EP psum
    assert rec["collectives"]["all-gather"]["count"] > 0       # weights
    assert rec["roofline"]["step_time_s"] > 0
