"""The port's training stack against the JAX package on the CPU: the loss
and its gradients, AdamW and Adafactor, the schedules, the token pipeline,
checkpoints, the ``Supervisor``'s crash-resume, gradient accumulation and
the ``train`` CLI.

Parameters are the reference's tree (stacked over groups, shapes from
``jax.eval_shape`` of its ``init_params``) filled from numpy under a seed
and carried across with ``interop.lm_params_from_arrays``. Float32
results agree within ``1e-5 * max(1, max|ref|)`` per leaf (float32 sums in
another order) unless a test says why not.
"""
import io
import contextlib
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import optim as JO
from repro.checkpoint import checkpoint as JCK
from repro.configs import get_config as jget_config
from repro.data import pipeline as JP
from repro.launch import train as jtrain
from repro.models import model as JM

from repro_torch import optim as TO
from repro_torch.checkpoint import checkpoint as TCK
from repro_torch.configs import get_config
from repro_torch.data import pipeline as TP
from repro_torch.interop import lm_params_from_arrays
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import TrainState, make_train_step
from repro_torch.models import model as TM
from repro_torch.optim.adamw import leaf_stacks, leaves
from repro_torch.runtime import Supervisor
from torch_threads import two_threads  # noqa: F401 (autouse)

REL = 1e-5
ARCHS = ["llama3.2-1b", "mamba2-1.3b", "granite-moe-1b-a400m",
         "jamba-1.5-large-398b"]


def _rel_close(got, want, rel=REL, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


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


def _lm_pair(arch: str, seed: int = 0):
    """(reference config, port config, the numpy tree) for ``arch``
    reduced."""
    jcfg = jget_config(arch, reduced=True)
    shapes = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, s: _leaf(rng, path[-1].key, s.shape, jcfg.d_model),
        shapes)
    return jcfg, get_config(arch, reduced=True), tree


def _ref_leaf(tree, name: str, group_size: int):
    """The reference tree's value for the port's parameter ``name``
    (``layers.<l>.<path>`` is ``groups[l % gs][path][l // gs]``)."""
    parts = name.split(".")
    if parts[0] == "layers":
        l = int(parts[1])
        node = tree["groups"][l % group_size]
        for k in parts[2:]:
            node = node[k]
        return np.asarray(node[l // group_size])
    node = tree
    for k in parts:
        node = node[k]
    return np.asarray(node)


def _port_leaves_of(tree, params, group_size):
    """A reference tree's values in ``leaves(params)`` order."""
    names = {id(p): n for n, p in params.named_parameters()}
    return [torch.from_numpy(np.array(_ref_leaf(tree, names[id(p)],
                                                group_size)))
            for p in leaves(params)]


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    jcfg, tcfg, tree = _lm_pair(request.param)
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab, (2, 13)).astype(np.int32)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, t: JM.loss_fn(p, jcfg, t), has_aux=True))(
            jp, jnp.asarray(tokens))
    tp = lm_params_from_arrays(tree, tcfg, device="cpu")
    tl, tm = TM.loss_fn(tp, tcfg, torch.from_numpy(tokens))
    tg = torch.autograd.grad(tl, leaves(tp))
    return {"jcfg": jcfg, "tcfg": tcfg, "tree": tree, "tparams": tp,
            "ref": (float(jl), {k: float(v) for k, v in jm.items()},
                    jax.tree_util.tree_map(np.asarray, jg)),
            "port": (float(tl.detach()),
                     {k: float(v.detach()) for k, v in tm.items()}, tg)}


def test_loss_matches_reference(lm):
    (jl, jm, _), (tl, tm, _) = lm["ref"], lm["port"]
    _rel_close(tl, jl)
    for k in ("ce", "aux", "tokens"):
        _rel_close(tm[k], jm[k], what=k)


def test_every_gradient_leaf_matches_reference(lm):
    """remat on (each group and each loss chunk recomputed in the
    backward pass, each SSM chunk too), MoE through the per-expert
    route."""
    tp, gs = lm["tparams"], lm["tcfg"].group_size
    jg, tg = lm["ref"][2], lm["port"][2]
    names = {id(p): n for n, p in tp.named_parameters()}
    assert len(tg) == len(names)
    for p, g in zip(leaves(tp), tg):
        name = names[id(p)]
        _rel_close(g.numpy(), _ref_leaf(jg, name, gs), what=name)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mamba2():
    """mamba2 reduced: two groups of one slot, so every layer leaf is
    stacked [2, ...] in the reference — Adafactor factors its vectors
    (``A_log`` [2, 8], norm scales) across the two layers."""
    jcfg, tcfg, tree = _lm_pair("mamba2-1.3b", seed=2)
    rng = np.random.default_rng(3)
    grads = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32)
        * np.float32(0.3), tree)
    return jcfg, tcfg, tree, grads


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_steps_on_the_lm_tree_match_reference(mamba2, name):
    """Two updates with the same gradients on both sides (the
    warmup-cosine schedule, global-norm clipping): the parameters and the
    optimizer state (Adafactor's stacked row/column factors) agree."""
    jcfg, tcfg, tree, grads = mamba2
    sched = (JO.warmup_cosine(1e-2, 1, 10), TO.warmup_cosine(1e-2, 1, 10))
    jopt = JO.make_optimizer(name, sched[0])
    topt = TO.make_optimizer(name, sched[1])
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jg = jax.tree_util.tree_map(jnp.asarray, grads)
    jupd = jax.jit(jopt.update)
    js = jopt.init(jp)
    tp = lm_params_from_arrays(tree, tcfg, device="cpu")
    tg = _port_leaves_of(grads, tp, tcfg.group_size)
    ts = topt.init(tp)
    for _ in range(2):
        jp, js, jm = jupd(jg, js, jp)
        tp, ts, tm = topt.update(tg, ts, tp)
        _rel_close(float(tm["lr"]), float(jm["lr"]), 1e-7)
        _rel_close(float(tm["grad_norm"]), float(jm["grad_norm"]))
    jpn = jax.tree_util.tree_map(np.asarray, jp)
    for n, p in tp.named_parameters():
        _rel_close(p.detach().numpy(), _ref_leaf(jpn, n, tcfg.group_size),
                   what=n)
    assert int(ts.step) == int(js.step) == 2
    if name == "adafactor":
        # the state follows the reference's stacked leaves
        jvr = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path): np.asarray(v)
               for path, v in jax.tree_util.tree_leaves_with_path(js.vr)}
        stacks = leaf_stacks(tp)
        assert len(stacks) == len(jvr) == len(ts.vr)
        for (n, ts_, stacked), vr in zip(stacks, ts.vr):
            parts = n.split(".")
            key = "/".join(["groups", parts[1]] + parts[2:]) if stacked \
                else "/".join(parts)
            _rel_close(vr.numpy(), jvr[key], what=key)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_descends_quadratic(name):
    target = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 16)).astype(np.float32))
    params = {"w": torch.zeros((8, 16)), "b": torch.zeros((16,))}
    opt = TO.make_optimizer(name, TO.constant_lr(0.05))
    state = opt.init(params)

    def loss(p):
        return torch.mean((p["w"] - target) ** 2) + torch.mean(p["b"] ** 2)

    l0 = float(loss(params))
    for _ in range(200):
        ps = leaves(params)
        for p in ps:
            p.requires_grad_(True)
        grads = torch.autograd.grad(loss(params), ps)
        for p in ps:
            p.requires_grad_(False)
        params, state, metrics = opt.update(grads, state, params)
    assert float(loss(params)) < 0.05 * l0
    assert np.isfinite(float(metrics["grad_norm"]))


def test_warmup_cosine_and_constant_lr_match_reference():
    cases = ((1e-3, 10, 100), (3e-4, 2000, 100_000), (1e-2, 1, 3))
    steps = [np.arange(0, c[2] + 5, max(c[2] // 37, 1), dtype=np.int32)
             for c in cases]
    wants = jax.jit(lambda *xs: [JO.warmup_cosine(*c)(x)
                                 for c, x in zip(cases, xs)])(*steps)
    for c, x, want in zip(cases, steps, wants):
        got = TO.warmup_cosine(*c)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=0)
    lrs = [float(TO.warmup_cosine(1e-3, 10, 100)(torch.tensor(s)))
           for s in range(0, 100, 5)]
    assert lrs[0] < lrs[1] and max(lrs) <= 1e-3 + 1e-9
    assert 1e-4 - 1e-9 <= lrs[-1] < lrs[3]
    assert float(TO.constant_lr(0.25)(torch.tensor(3))) == 0.25


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(4)
    tree = {"a": np.full((4,), 100.0, np.float32),
            "b": rng.standard_normal((3, 5)).astype(np.float32)}
    jc, jn = JO.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, tree), 1.0)
    tc, tn = TO.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in tree.items()}, 1.0)
    _rel_close(float(tn), float(jn))
    assert float(tn) == pytest.approx(np.sqrt(40000 + (tree["b"] ** 2).sum()))
    for got, key in zip(tc, ("a", "b")):
        _rel_close(got.numpy(), np.asarray(jc[key]), what=key)
    assert abs(float(TO.global_norm(tc)) - 1.0) < 1e-5


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(vocab=97, batch=8, seq=16, seed=3),
                                dict(vocab=97, batch=8, seq=16, seed=3,
                                     dp_rank=1, dp_size=2),
                                dict(vocab=50280, batch=4, seq=33, seed=0,
                                     zipf_a=1.1)])
def test_pipeline_batches_bitwise_reference(kw):
    jpipe, tpipe = JP.TokenPipeline(**kw), TP.TokenPipeline(**kw)
    for step in (0, 5, 1234):
        a, b = jpipe.batch_at(step), tpipe.batch_at(step)
        assert a["step"] == b["step"] == step
        assert b["tokens"].dtype == a["tokens"].dtype
        np.testing.assert_array_equal(b["tokens"], a["tokens"])
    assert tpipe.local_batch == kw["batch"] // kw.get("dp_size", 1)


def test_pipeline_iterator_resume():
    pipe = TP.TokenPipeline(vocab=31, batch=2, seq=8, seed=0)
    assert [b["step"] for b in TP.make_batch_iterator(pipe, stop_step=6)] \
        == list(range(6))
    resumed = list(TP.make_batch_iterator(pipe, start_step=3, stop_step=6))
    assert [b["step"] for b in resumed] == [3, 4, 5]
    ref = list(JP.make_batch_iterator(JP.TokenPipeline(vocab=31, batch=2,
                                                       seq=8, seed=0),
                                      start_step=3, stop_step=6))
    for a, b in zip(resumed, ref):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------
def _listing(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def test_checkpoint_roundtrip_and_layout(tmp_path):
    """A tree of a module, a named tuple, a bf16 leaf and an int32 step
    comes back into a zeroed target; the files are the reference's
    (``step_<N>/manifest.json``, ``shard_<host>.npz``,
    ``step_<N>.COMMITTED``)."""
    d = str(tmp_path / "port")
    params = TM.ParamTree({"w": torch.arange(12.0).reshape(3, 4),
                           "sub": {"b": torch.ones(2, dtype=torch.bfloat16)
                                   * 1.5}})
    tree = {"params": params, "opt": TO.AdamWState(
        torch.tensor(7, dtype=torch.int32), [torch.full((3,), 2.0)],
        [torch.full((3,), 3.0)])}
    TCK.save(d, 7, tree, blocking=True, meta={"arch": "x"})
    assert TCK.latest_step(d) == 7
    assert TCK.restore_meta(d, 7) == {"arch": "x"}
    target = {"params": TM.ParamTree({
        "w": torch.zeros(3, 4),
        "sub": {"b": torch.zeros(2, dtype=torch.bfloat16)}}),
        "opt": TO.AdamWState(torch.tensor(0, dtype=torch.int32),
                             [torch.zeros(3)], [torch.zeros(3)])}
    back = TCK.restore(d, 7, target)
    assert back is target
    assert torch.equal(back["params"]["w"], params["w"])
    assert back["params"]["sub"]["b"].dtype == torch.bfloat16
    assert torch.equal(back["params"]["sub"]["b"], params["sub"]["b"])
    assert int(back["opt"].step) == 7
    assert torch.equal(back["opt"].v[0], torch.full((3,), 3.0))
    dj = str(tmp_path / "ref")
    JCK.save(dj, 7, {"w": jnp.zeros(2)}, blocking=True)
    assert _listing(d) == _listing(dj) == [
        "step_00000007.COMMITTED", "step_00000007/manifest.json",
        "step_00000007/shard_00000.npz"]


def test_checkpoint_retention_and_latest(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = {"x": torch.zeros((2,))}
    for s in [10, 20, 30, 40]:
        TCK.save(d, s, tree, blocking=True, keep=2)
    assert TCK.latest_step(d) == 40
    assert sorted(f for f in os.listdir(d) if f.endswith("COMMITTED")) == \
        ["step_00000030.COMMITTED", "step_00000040.COMMITTED"]
    assert TCK.latest_step(str(tmp_path / "none")) is None


def test_checkpoint_shape_mismatch_raises(tmp_path):
    d = str(tmp_path / "ckpt")
    TCK.save(d, 1, {"w": torch.zeros((3,))}, blocking=True)
    with pytest.raises(ValueError, match="leaf w"):
        TCK.restore(d, 1, {"w": torch.zeros((4,))})
    with pytest.raises(ValueError, match="1 leaves"):
        TCK.restore(d, 1, {"w": torch.zeros((3,)), "v": torch.zeros(1)})


def test_async_save_holds_the_values_at_the_call(tmp_path):
    """``save`` copies to the host before it returns: an in-place update
    right after a non-blocking save does not reach the checkpoint."""
    d = str(tmp_path / "ckpt")
    w = torch.arange(6.0)
    t = TCK.save(d, 1, {"w": w}, blocking=False)
    w.add_(100.0)
    t.join(timeout=60)
    assert not t.is_alive()
    back = TCK.restore(d, 1, {"w": torch.zeros(6)})
    assert torch.equal(back["w"], torch.arange(6.0))


# ---------------------------------------------------------------------------
# fault tolerance: crash + resume is bit-exact
# ---------------------------------------------------------------------------
def _toy_training(ckpt_dir, num_steps, fail_at=None, start_fresh=True):
    """Tiny linear-regression train loop driven by the Supervisor (the
    reference's test_substrate case, in torch)."""
    pipe = TP.TokenPipeline(vocab=64, batch=4, seq=9, seed=1)
    opt = TO.adamw(TO.constant_lr(0.05))
    params = {"w": torch.zeros((8, 8))}
    state = {"params": params, "opt": opt.init(params)}

    def step_fn(state, batch):
        tokens = torch.from_numpy(batch["tokens"]).to(torch.float32)
        x, y = tokens[:, :-1], tokens[:, 1:]
        w = state["params"]["w"].requires_grad_(True)
        loss = torch.mean((x.T @ x @ w - y.T @ y) ** 2)
        (g,) = torch.autograd.grad(loss, [w])
        w.requires_grad_(False)
        new_p, new_opt, m = opt.update([g], state["opt"], state["params"])
        return {"params": new_p, "opt": new_opt}, {"loss": m["grad_norm"]}

    sup = Supervisor(ckpt_dir, save_every=2, keep=5)
    start = None
    if not start_fresh:
        restored, resume = sup.restore(state)
        if restored is not None:
            state, start = restored, resume
    return sup.run(state, num_steps, step_fn, lambda s: pipe.batch_at(s),
                   fail_at=fail_at, start_step=start)


def test_crash_resume_bit_exact(tmp_path):
    final_ref = _toy_training(str(tmp_path / "nofail"), 9)
    d2 = str(tmp_path / "fail")
    with pytest.raises(RuntimeError, match="injected failure"):
        _toy_training(d2, 9, fail_at=5)
    # step 4's save may still be flushing: the resume takes what is
    # committed
    assert TCK.latest_step(d2) in (2, 4)
    final = _toy_training(d2, 9, start_fresh=False)
    assert torch.equal(final["params"]["w"], final_ref["params"]["w"])
    for a, b in zip(final["opt"].m + final["opt"].v,
                    final_ref["opt"].m + final_ref["opt"].v):
        assert torch.equal(a, b)
    assert int(final["opt"].step) == int(final_ref["opt"].step) == 9
    assert TCK.latest_step(d2) == 9


def test_supervisor_restores_a_given_step_and_saves_once(tmp_path):
    d = str(tmp_path / "ckpt")
    sup = Supervisor(d, save_every=2, keep=5)
    tree = {"x": torch.zeros(2)}
    sup.run(tree, 4, lambda s, b: ({"x": s["x"] + 1}, {}), lambda s: None)
    assert sorted(f for f in os.listdir(d) if f.endswith("COMMITTED")) == \
        ["step_00000002.COMMITTED", "step_00000004.COMMITTED"]
    back, step = Supervisor(d).restore({"x": torch.zeros(2)})
    assert step == 4 and torch.equal(back["x"], torch.full((2,), 4.0))
    back = TCK.restore(d, 2, {"x": torch.zeros(2)})
    assert torch.equal(back["x"], torch.full((2,), 2.0))
    assert Supervisor(str(tmp_path / "empty")).restore(tree) == (None, 0)


# ---------------------------------------------------------------------------
# train steps and the CLI
# ---------------------------------------------------------------------------
def test_grad_accumulation_parity():
    """grad_accum=4 reproduces the grad_accum=1 update (within float32
    reassociation), as the reference's test_system case checks."""
    jcfg, tcfg, tree = _lm_pair("llama3.2-1b", seed=5)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, tcfg.vocab, (8, 32)).astype(np.int32))
    opt = TO.make_optimizer("adamw", TO.constant_lr(1e-2))
    out = []
    for ga in (1, 4):
        params = lm_params_from_arrays(tree, tcfg, device="cpu")
        s, m = make_train_step(tcfg, opt, grad_accum=ga)(
            TrainState(params, opt.init(params)), {"tokens": tokens})
        out.append((s, m))
    (s1, m1), (s4, m4) = out
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)
    for a, b in zip(leaves(s1.params), leaves(s4.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-4, atol=1e-6)


def test_train_step_refuses_k9():
    cfg = get_config("granite-moe-1b-a400m", reduced=True)
    import dataclasses
    with pytest.raises(NotImplementedError, match="no backward"):
        make_train_step(dataclasses.replace(cfg, moe_use_kernel=True),
                        TO.make_optimizer("adamw", TO.constant_lr(1e-3)))


def test_train_cli_matches_reference(tmp_path, monkeypatch):
    """``launch.train.main`` in this process against the reference CLI,
    3 steps of mamba2 reduced from the reference's own initial parameters
    (the tree its ``init_params(PRNGKey(0))`` returned in its run, carried
    across in place of the port's draw). The reference prints each loss
    to 4 decimals, so a step's loss agrees within 1e-4 relative plus half
    the last printed digit; the final losses (returned unrounded) within
    1e-4 relative."""
    argv = ["--arch", "mamba2-1.3b", "--reduced", "--steps", "3",
            "--batch", "2", "--seq", "16", "--save-every", "2"]
    seen = []

    def recording_init(key, cfg):
        # jitted: the reference's eager init compiles each random op
        params = jax.jit(lambda k: JM.init_params(k, cfg))(key)
        # a copy: the reference's jitted step donates (deletes) them
        seen.append(jax.tree_util.tree_map(lambda x: np.array(x, copy=True),
                                           params))
        return params

    monkeypatch.setattr(jtrain, "init_params", recording_init)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        jfinal = jtrain.main(argv + ["--ckpt-dir", str(tmp_path / "ref")])
    jlosses = [float(x) for x in re.findall(r"step \d+ loss=([0-9.]+)",
                                            out.getvalue())]
    monkeypatch.setattr(ttrain, "init_params", lambda gen, cfg:
                        lm_params_from_arrays(seen[0], cfg,
                                              device=gen.device))
    d = str(tmp_path / "port")
    res = ttrain.main(argv + ["--ckpt-dir", d, "--device", "cpu"])
    assert len(res["losses"]) == len(jlosses) == 3
    for got, want in zip(res["losses"], jlosses):
        assert abs(got - want) <= 1e-4 * abs(want) + 5e-5, (got, want)
    assert abs(res["final_loss"] - jfinal) <= 1e-4 * abs(jfinal)
    assert TCK.latest_step(d) == 3
    # --resume auto picks up the final checkpoint and has nothing to do
    again = ttrain.main(argv + ["--ckpt-dir", d, "--device", "cpu",
                                "--resume", "auto"])
    assert again["start"] == 3 and again["losses"] == []
    # a mesh needs its positions: the machine's cards unless named
    with pytest.raises(ValueError, match="the mesh needs 2 devices"):
        ttrain.main(argv + ["--mesh", "2x1", "--device", "cpu"])


def test_replayed_update_holds_the_restored_optimizer_state(tmp_path):
    """The resume check of ``chip_smoke.py``'s training phase: the last
    step, replayed from the checkpoint before it, gives the uninterrupted
    run's last parameters (bit for bit on the CPU), while a restore that
    lost the AdamW moments or the step count leaves the replayed loss
    (read before the update) as it was and moves the parameters by far
    more than the phase's 1e-2 of the update."""
    from repro_torch.optim import make_optimizer, warmup_cosine
    steps, lr = 3, 1e-3
    argv = ["--arch", "mamba2-1.3b", "--reduced", "--steps", str(steps),
            "--batch", "2", "--seq", "16", "--save-every", "2", "--lr",
            str(lr), "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    run = ttrain.main(argv)
    final = leaves(run["state"].params)
    opt = make_optimizer("adamw", warmup_cosine(lr, 1, steps))
    os.remove(tmp_path / f"step_{steps:08d}.COMMITTED")
    pipe = TP.TokenPipeline(vocab=run["cfg"].vocab, batch=2, seq=16, seed=0)
    step_fn = make_train_step(run["cfg"], opt)
    off = {}
    for lost in ("nothing", "moments", "step"):
        params = TM.init_params(torch.Generator().manual_seed(1), run["cfg"])
        state, start = Supervisor(str(tmp_path)).restore(
            TrainState(params, opt.init(params)))
        assert start == 2
        st = state.opt
        if lost == "moments":
            st = st._replace(m=[torch.zeros_like(t) for t in st.m],
                             v=[torch.zeros_like(t) for t in st.v])
        elif lost == "step":
            st = st._replace(step=torch.zeros_like(st.step))
        with torch.no_grad():
            upd = sum((f - t).double().square().sum()
                      for f, t in zip(final, leaves(state.params)))
        state, m = step_fn(TrainState(state.params, st), {
            "tokens": torch.from_numpy(pipe.batch_at(2)["tokens"])})
        assert float(m["loss"]) == run["losses"][2]
        with torch.no_grad():
            err = sum((t - f).double().square().sum()
                      for t, f in zip(leaves(state.params), final))
        off[lost] = float((err / upd).sqrt())
    assert off["nothing"] == 0.0, off
    assert off["moments"] > 0.1 and off["step"] > 0.1, off
