"""Train / serve step builders and abstract input specs for every
(architecture x shape) cell (the port of ``repro.launch.steps``).

A step runs eagerly. On one device ``train_step`` updates the parameters
and the optimizer state in place and returns them in a new
``TrainState`` with the metrics (float32 scalar tensors).

On a mesh (``make_train_step(..., mesh=)``) the parameters and the
optimizer state live placed by ``param_shardings``/``opt_state_shardings``
between steps (:func:`place_train_state`: one block per mesh position).
A step splits the batch over ``cfg.batch_axes`` and runs one forward per
data block on the block's device with the weights gathered there (inside
``at_coords``, so the model knows its batch is a block). The MoE aux loss
of the whole batch is formed from the blocks' routing statistics
(``moe.route_log``) before each block's backward pass, so the loss and
the gradient are those of the whole batch. The gradients are reduced
onto the first block's device, the optimizer updates the gathered leaves
(Adafactor's factors span whole stacked leaves; AdamW takes the same
path), and the updated leaves go back to the shards. The step function,
the losses and the checkpoint layout (:func:`gather_train_state`) are
those of one device.

The abstract half (:func:`abstract_params`, :func:`abstract_train_state`,
:func:`input_specs`, :func:`cell_config`, :func:`lower_cell`) builds the
cell's inputs as ``meta`` tensors (shapes and dtypes, no storage) with
their shardings attached, and :func:`lower_cell`'s ``compile()`` runs the
step once on them under the op counter (``roofline.op_count``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import SHAPES, get_config
from repro_torch.models.model import (ModelConfig, ParamTree, decode_step,
                                      init_cache, init_params, loss_fn,
                                      prefill)
from repro_torch.models.layers import META_INIT
from repro_torch.models.moe import route_log
from repro_torch.optim import Optimizer, make_optimizer, warmup_cosine
from repro_torch.optim.adamw import leaves
from repro_torch.roofline import op_count
from . import shardings as shd
from .mesh import Mesh, at_coords, dp_axes, set_mesh


class TrainState(NamedTuple):
    params: Any
    opt: Any


def default_optimizer(cfg: ModelConfig) -> Optimizer:
    # jamba-398B cannot hold AdamW state: factored second moments there
    name = "adafactor" if cfg.d_model >= 8192 else "adamw"
    return make_optimizer(name, warmup_cosine(3e-4, 2000, 100_000))


def _grads(loss: torch.Tensor, params) -> list:
    """d loss / d leaves(params); zeros for a leaf the loss does not use
    (as ``jax.grad`` gives)."""
    ps = leaves(params)
    gs = torch.autograd.grad(loss, ps, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(ps, gs)]


# ---------------------------------------------------------------------------
# parameters and optimizer state placed on a mesh
# ---------------------------------------------------------------------------
def tree_from_named(named, group_size: int = 0) -> ParamTree:
    """A ``ParamTree`` from ``(name, tensor)`` pairs in parameter order
    (``layers.<l>.a.b`` names become the layer list)."""
    root: Dict[str, Any] = {}
    for name, t in named:
        parts = name.split(".")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return ParamTree(lists(root), group_size)


class MeshParams:
    """The LM's parameters placed on a mesh: a ``ShardedTensor`` per
    tensor of its ``ParamTree``, by name, in parameter order."""

    def __init__(self, placed: Dict[str, shd.ShardedTensor],
                 group_size: int):
        self.placed = placed
        self.group_size = group_size
        self.leaf_names: Optional[List[str]] = None

    def gather(self, device) -> ParamTree:
        """The whole parameters on ``device``, as a ``ParamTree`` (an
        all-gather of every leaf, recorded for the op counter)."""
        named = []
        for n, st in self.placed.items():
            with op_count.uncounted():
                t = st.gather(device)
            op_count.record_collective("all-gather",
                                       t.numel() * t.element_size())
            named.append((n, t))
        return tree_from_named(named, self.group_size)

    def parameters(self):
        return iter(self.placed.values())


def _place_field(value, shardings):
    if isinstance(value, torch.Tensor):
        return value
    return [shd.ShardedTensor.place(t, sh) for t, sh in zip(value,
                                                            shardings)]


def place_train_state(state: TrainState, mesh: Mesh,
                      profile: str = "tp") -> TrainState:
    """Place a one-device ``TrainState`` on ``mesh``: every parameter by
    ``param_shardings``, every optimizer tensor by
    ``opt_state_shardings`` (the step counter stays one scalar)."""
    params = state.params
    names = {id(p): n for n, p in params.named_parameters()}
    shs = dict(zip((names[id(p)] for p in leaves(params)),
                   shd.param_shardings(params, mesh, profile)))
    with op_count.uncounted():
        placed = {n: shd.ShardedTensor.place(p, shs[n])
                  for n, p in params.named_parameters()}
        osh = shd.opt_state_shardings(state.opt, params, mesh, profile)
        opt = type(state.opt)(*(_place_field(v, s)
                                for v, s in zip(state.opt, osh)))
    return TrainState(MeshParams(placed, params.group_size), opt)


def _gather_field(value, device):
    if isinstance(value, torch.Tensor):
        return value.to(device)
    out = []
    for st in value:
        with op_count.uncounted():
            t = st.gather(device)
        op_count.record_collective("all-gather",
                                   t.numel() * t.element_size())
        out.append(t)
    return out


def gather_train_state(state: TrainState, device) -> TrainState:
    """A placed ``TrainState`` whole on ``device``: the one-device state
    (and checkpoint layout) it stands for."""
    if not isinstance(state.params, MeshParams):
        return state
    return TrainState(state.params.gather(device),
                      type(state.opt)(*(_gather_field(v, device)
                                        for v in state.opt)))


def _scatter_back(placed: List[shd.ShardedTensor], whole) -> None:
    """Copy each updated whole tensor into its shards."""
    with op_count.uncounted(), torch.no_grad():
        for st, t in zip(placed, whole):
            if t.is_meta:
                continue
            for pos, block in st.shards.items():
                block.copy_(t[st.sharding.index(pos, st.shape)])


def _data_blocks(mesh: Mesh, axes: Tuple[str, ...]):
    """``[(coords, device)]``: one entry per block of the batch along
    ``axes`` (row-major), at its first position's device."""
    size = dict(zip(mesh.axis_names, mesh.devices.shape))
    out = []
    for pos in shd.positions(mesh):
        c = dict(zip(mesh.axis_names, pos))
        if all(v == 0 for a, v in c.items() if a not in axes):
            out.append(({a: c[a] for a in axes}, mesh.devices[pos]))
    assert len(out) == int(np.prod([size[a] for a in axes]))
    return out


def _mesh_train_step(cfg: ModelConfig, optimizer: Optimizer, mesh: Mesh,
                     grad_accum: int):
    axes = tuple(cfg.batch_axes)
    blocks = _data_blocks(mesh, axes)
    nb = len(blocks)
    dev0 = blocks[0][1]

    def forward_backward(mp: MeshParams, tokens, vis):
        """Loss metrics and gradients (on ``dev0``, leaves order) of one
        (micro)batch: a forward per data block, the whole batch's aux
        loss from the blocks' routing statistics, a backward per block,
        the block gradients averaged."""
        B = tokens.shape[0]
        if B % nb:
            raise ValueError(f"batch {B} is not a multiple of the {nb} "
                             f"data blocks of {axes}")
        Bl = B // nb
        # on meta the blocks' ops are equal: op_count runs the first for all
        runs = []
        for j, (coords, dev) in enumerate(op_count.equal_passes(blocks,
                                                                tokens)):
            t = tokens[j * Bl:(j + 1) * Bl].to(dev)
            v = None if vis is None else vis[j * Bl:(j + 1) * Bl].to(dev)
            tp = mp.gather(dev)
            with at_coords(coords), route_log() as log:
                _, m = loss_fn(tp, cfg, t, vision_embeds=v)
            runs.append((tp, m["ce"], log))
        # the whole batch's routing statistics per MoE call: equal blocks,
        # so the token shares and mean probabilities are block means
        n_calls = len(runs[0][2])
        frac = [torch.stack([r[2][i][0].to(dev0) for r in runs]).mean(0)
                for i in range(n_calls)]
        if nb > 1 and n_calls:
            op_count.record_collective("all-reduce",
                                       4 * frac[0].numel() * n_calls, nb)
        aux = torch.zeros((), dtype=torch.float32, device=dev0)
        for i in range(n_calls):
            w = runs[0][2][i][2]
            mp_i = torch.stack([r[2][i][1].detach().to(dev0)
                                for r in runs]).mean(0)
            aux = aux + w * torch.sum(frac[i] * mp_i)
        grads = None
        ce = torch.zeros((), dtype=torch.float32, device=dev0)
        for j, (coords, dev) in enumerate(op_count.equal_passes(blocks,
                                                                tokens)):
            tp, ce_j, log = runs[j]
            runs[j] = None              # the block's copy goes with it
            # this block's share of the whole batch's loss: its ce plus
            # the aux terms of its own mean probabilities
            lj = ce_j
            for i in range(n_calls):
                w = log[i][2]
                lj = lj + w * torch.sum(frac[i].to(dev) * log[i][1])
            # at the forward's coordinates: remat recomputes it here
            with at_coords(coords):
                gj = _grads(lj, tp)
            ce = ce + ce_j.detach().to(dev0)
            with op_count.uncounted():
                gj = [g.to(dev0) for g in gj]
            grads = gj if grads is None else [a.add_(b) for a, b in
                                              zip(grads, gj)]
            del tp, gj, log
        inv = 1.0 / len(runs)
        grads = [g.mul_(inv) for g in grads]
        ce = ce * inv
        return ce + aux, ce, aux, grads

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        mp: MeshParams = state.params
        tokens = batch["tokens"]
        vis = batch.get("vision_embeds")
        with set_mesh(mesh):
            B = tokens.shape[0]
            if B % grad_accum:
                raise ValueError(f"batch {B} is not a multiple of "
                                 f"grad_accum {grad_accum}")
            mb = B // grad_accum
            grads, l_sum, ce_sum, aux_sum = None, 0.0, 0.0, 0.0
            for i in range(grad_accum):
                v = None if vis is None else vis[i * mb:(i + 1) * mb]
                l, ce, aux, g = forward_backward(
                    mp, tokens[i * mb:(i + 1) * mb], v)
                grads = g if grads is None else [a.add_(b) for a, b in
                                                 zip(grads, g)]
                l_sum, ce_sum, aux_sum = l_sum + l, ce_sum + ce, \
                    aux_sum + aux
            if grad_accum > 1:
                inv = 1.0 / grad_accum
                grads = [g.mul_(inv) for g in grads]
                l_sum, ce_sum, aux_sum = l_sum * inv, ce_sum * inv, \
                    aux_sum * inv
            # the reduced gradients land on the shards
            for st in _leaf_order(mp):
                op_count.record_collective("reduce-scatter",
                                           st.shard_bytes(), mesh.size)
            # the update on the gathered leaves, then back to the shards
            tp = mp.gather(dev0)
            opt = type(state.opt)(*(_gather_field(v, dev0)
                                    for v in state.opt))
            tp, opt, om = optimizer.update(grads, opt, tp)
            _scatter_back(_leaf_order(mp), leaves(tp))
            new_opt = []
            for placed, whole in zip(state.opt, opt):
                if isinstance(placed, torch.Tensor):
                    new_opt.append(whole)
                else:
                    _scatter_back(placed, whole)
                    new_opt.append(placed)
        out = {"loss": l_sum, "ce": ce_sum, "aux": aux_sum, **om}
        return TrainState(mp, type(state.opt)(*new_opt)), out

    return train_step


def _leaf_order(mp: MeshParams) -> List[shd.ShardedTensor]:
    """The placed tensors in ``leaves`` order (the gradients' order)."""
    if mp.leaf_names is None:
        meta = tree_from_named([(n, torch.empty(0, device="meta"))
                                for n in mp.placed], mp.group_size)
        by_id = {id(p): n for n, p in meta.named_parameters()}
        mp.leaf_names = [by_id[id(p)] for p in leaves(meta)]
    return [mp.placed[n] for n in mp.leaf_names]


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    grad_accum: int = 1, mesh: Optional[Mesh] = None):
    """Train step; grad_accum > 1 splits the batch into microbatches and
    sums their float32 gradients before one optimizer update (activation
    memory scales 1/n_micro). With ``mesh`` the state is placed
    (:func:`place_train_state`) and the batch split over
    ``cfg.batch_axes`` (module docstring). MoE layers train through the
    per-expert route: K9 has no backward (as in the reference, whose
    Pallas kernel has none)."""
    if cfg.moe_use_kernel:
        raise NotImplementedError("K9 (moe_use_kernel) has no backward: "
                                  "train with moe_use_kernel=False")
    if mesh is not None:
        return _mesh_train_step(cfg, optimizer, mesh, grad_accum)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        tokens = batch["tokens"]
        vis = batch.get("vision_embeds")
        params = state.params
        if grad_accum == 1:
            loss, metrics = loss_fn(params, cfg, tokens, vision_embeds=vis)
            grads = _grads(loss, params)
            loss = loss.detach()
            ce, aux = metrics["ce"].detach(), metrics["aux"].detach()
        else:
            B = tokens.shape[0]
            if B % grad_accum:
                raise ValueError(f"batch {B} is not a multiple of "
                                 f"grad_accum {grad_accum}")
            mb = B // grad_accum
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves(params)]
            zero = torch.zeros((), dtype=torch.float32,
                               device=tokens.device)
            l_sum, ce_sum, aux_sum = zero, zero, zero
            for i in range(grad_accum):
                t = tokens[i * mb:(i + 1) * mb]
                v = None if vis is None else vis[i * mb:(i + 1) * mb]
                l, m = loss_fn(params, cfg, t, vision_embeds=v)
                for acc, g in zip(grads, _grads(l, params)):
                    acc.add_(g)
                l_sum = l_sum + l.detach()
                ce_sum = ce_sum + m["ce"].detach()
                aux_sum = aux_sum + m["aux"].detach()
            inv = 1.0 / grad_accum
            grads = [g * inv for g in grads]
            loss, ce, aux = l_sum * inv, ce_sum * inv, aux_sum * inv

        params, opt, om = optimizer.update(grads, state.opt, params)
        out = {"loss": loss, "ce": ce, "aux": aux, **om}
        return TrainState(params, opt), out

    return train_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(params, caches, token, pos):
        return decode_step(params, cfg, token, caches, pos)
    return serve_step


def make_prefill(cfg: ModelConfig, S_max: int):
    def prefill_step(params, tokens, vision_embeds=None):
        return prefill(params, cfg, tokens, S_max,
                       vision_embeds=vision_embeds)
    return prefill_step


# ---------------------------------------------------------------------------
# abstract inputs per cell
# ---------------------------------------------------------------------------
def _text_len(cfg: ModelConfig, seq: int) -> int:
    """VLM archs spend part of the context on vision tokens so the total
    context equals the assigned seq_len exactly."""
    return seq - (cfg.vision_tokens if cfg.frontend == "vision" else 0)


def abstract_params(cfg: ModelConfig, mesh: Mesh, profile: str = "tp"
                    ) -> ParamTree:
    """The parameters as ``meta`` tensors (no storage, whatever the
    width), each with its ``sharding`` attached."""
    params = init_params(META_INIT, cfg)
    return shd.with_shardings(params,
                              shd.param_shardings(params, mesh, profile))


def abstract_train_state(cfg: ModelConfig, optimizer: Optimizer,
                         mesh: Mesh, profile: str = "tp") -> TrainState:
    p = abstract_params(cfg, mesh, profile)
    opt = optimizer.init(p)
    shd.with_shardings(opt, shd.opt_state_shardings(opt, p, mesh, profile))
    return TrainState(p, opt)


def _meta(shape, dtype, sharding) -> torch.Tensor:
    t = torch.empty(shape, dtype=dtype, device="meta")
    sharding.shard_shape(shape)
    t.sharding = sharding
    return t


def input_specs(arch: str, shape_name: str, mesh: Mesh,
                cfg: Optional[ModelConfig] = None) -> Dict[str, Any]:
    """``meta`` stand-ins (shardable, zero allocation) for every input of
    the cell's step function."""
    cfg = cfg or get_config(arch)
    spec = SHAPES[shape_name]
    B, S = spec.batch, spec.seq
    bs = shd.batch_sharding(mesh, B)
    out: Dict[str, Any] = {"kind": spec.kind, "cfg": cfg}

    if spec.kind == "train":
        St = _text_len(cfg, S)
        batch = {"tokens": _meta((B, St), torch.int32, bs)}
        if cfg.frontend == "vision":
            batch["vision_embeds"] = _meta(
                (B, cfg.vision_tokens, cfg.vision_dim), torch.bfloat16, bs)
        out["batch"] = batch
    elif spec.kind == "prefill":
        St = _text_len(cfg, S)
        out["tokens"] = _meta((B, St), torch.int32, bs)
        if cfg.frontend == "vision":
            out["vision_embeds"] = _meta(
                (B, cfg.vision_tokens, cfg.vision_dim), torch.bfloat16, bs)
        out["s_max"] = S
    else:  # decode: one new token against a seq_len KV cache
        cache = init_cache(cfg, B, S, dtype=torch.bfloat16, device="meta")
        out["caches"] = shd.with_shardings(
            cache, shd.cache_shardings(cache, mesh, B))
        out["token"] = _meta((B, 1), torch.int32, bs)
        dp = dp_axes(mesh)
        out["pos"] = _meta((B,), torch.int32, shd.NamedSharding(
            mesh, shd.P(dp) if B % shd._axis_size(mesh, tuple(dp)) == 0
            else shd.P()))
    return out


def _moe_mode(cfg, mesh, kind: str = "train") -> str:
    """EP when experts divide the model axis; dropless expert-TP
    otherwise. Decode keeps the baseline dispatch: a handful of tokens
    per device cannot amortize the expert-parallel dispatch."""
    if kind == "decode":
        return ""
    if cfg.n_experts <= 0 or not cfg.batch_axes or cfg.seq_axes:
        return ""
    if cfg.n_experts % shd._axis_size(mesh, "model") == 0:
        return "ep"
    if cfg.d_ff % shd._axis_size(mesh, "model") == 0:
        return "ep_tp"
    return ""


def cell_config(arch: str, shape_name: str, mesh: Mesh,
                profile: str = "tp") -> ModelConfig:
    """The full config specialized for this cell: batch-axis constraints
    applied when the batch is shardable over DP, MoE dispatch mode, and
    optional sequence parallelism."""
    cfg = get_config(arch)
    B = SHAPES[shape_name].batch
    S = SHAPES[shape_name].seq
    dp = dp_axes(mesh)
    if profile in ("fsdp", "fsdp_seqp"):
        all_axes = tuple(mesh.axis_names)
        if profile == "fsdp" and B % shd._axis_size(mesh, all_axes) == 0:
            cfg = dataclasses.replace(cfg, batch_axes=all_axes)
        elif B % shd._axis_size(mesh, tuple(dp)) == 0:
            cfg = dataclasses.replace(cfg, batch_axes=tuple(dp))
        if profile == "fsdp_seqp" and SHAPES[shape_name].kind != "decode" \
                and S % shd._axis_size(mesh, "model") == 0:
            cfg = dataclasses.replace(
                cfg, seq_axes=("model",),
                seq_axes_size=shd._axis_size(mesh, "model"))
    elif B % shd._axis_size(mesh, tuple(dp)) == 0:
        cfg = dataclasses.replace(cfg, batch_axes=tuple(dp))
    return dataclasses.replace(
        cfg, moe_ep=_moe_mode(cfg, mesh, SHAPES[shape_name].kind))


class MemoryAnalysis(NamedTuple):
    """Per-device bytes from the shardings: the arguments (parameter,
    optimizer, cache and input shards), the outputs (the new state's
    shards and the metrics, or the logits and caches). Temporaries are
    not counted (None)."""
    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: Optional[int] = None
    generated_code_size_in_bytes: Optional[int] = None


class Compiled:
    """A cell's step, run once on ``meta`` tensors under the op counter."""

    def __init__(self, counter: op_count.OpCounter, memory: MemoryAnalysis,
                 chips: int):
        self.counter = counter
        self.memory = memory
        self.chips = chips

    def memory_analysis(self) -> MemoryAnalysis:
        return self.memory

    def cost_analysis(self) -> Dict[str, float]:
        """Per-device flops and bytes (the counts over every position,
        divided by the chips), as XLA's keys name them."""
        return {"flops": self.counter.flops / self.chips,
                "bytes accessed": self.counter.bytes / self.chips}


class Lowered:
    """A cell ready to run: ``compile()`` runs its step once."""

    def __init__(self, run, memory: MemoryAnalysis, chips: int):
        self._run = run
        self.memory = memory
        self.chips = chips

    def compile(self) -> Compiled:
        with op_count.OpCounter() as counter:
            self._run()
        return Compiled(counter, self.memory, self.chips)


def lower_cell(arch: str, shape_name: str, mesh: Mesh,
               cfg: Optional[ModelConfig] = None, profile: str = "tp",
               grad_accum: int = 1) -> Lowered:
    """The step function of one cell on ``mesh``, over ``meta`` inputs
    with their shardings; ``compile()`` runs it once under the op
    counter (nothing is allocated: a ``meta`` mesh, e.g.
    ``make_production_mesh(devices=["meta"] * 256)``)."""
    cfg = cfg or cell_config(arch, shape_name, mesh, profile)
    specs = input_specs(arch, shape_name, mesh, cfg)
    chips = mesh.size
    if specs["kind"] == "train":
        optimizer = default_optimizer(cfg)
        state = abstract_train_state(cfg, optimizer, mesh, profile)
        args = shd.shard_bytes(state) + shd.shard_bytes(specs["batch"])
        # outputs: the new state and five float32 metrics
        memory = MemoryAnalysis(args, shd.shard_bytes(state) + 5 * 4)

        def run():
            placed = place_train_state(state, mesh, profile)
            step = make_train_step(cfg, optimizer, grad_accum=grad_accum,
                                   mesh=mesh)
            step(placed, specs["batch"])
        return Lowered(run, memory, chips)
    params = abstract_params(cfg, mesh, profile)
    logits_bytes = specs["tokens"].shape[0] * cfg.vocab * 4 \
        if specs["kind"] == "prefill" else specs["token"].shape[0] \
        * cfg.vocab * 4
    n_dp = shd._axis_size(mesh, tuple(dp_axes(mesh)))
    if specs["kind"] == "prefill":
        args = shd.shard_bytes(params) + shd.shard_bytes(specs["tokens"])
        memory = MemoryAnalysis(args, logits_bytes // n_dp)

        def run():
            with set_mesh(mesh), torch.no_grad():
                make_prefill(cfg, specs["s_max"])(
                    params, specs["tokens"], specs.get("vision_embeds"))
        return Lowered(run, memory, chips)
    args = shd.shard_bytes(params) + shd.shard_bytes(specs["caches"]) \
        + shd.shard_bytes(specs["token"]) + shd.shard_bytes(specs["pos"])
    memory = MemoryAnalysis(args, logits_bytes // n_dp
                            + shd.shard_bytes(specs["caches"]))

    def run():
        with set_mesh(mesh), torch.no_grad():
            make_decode_step(cfg)(params, specs["caches"], specs["token"],
                                  specs["pos"])
    return Lowered(run, memory, chips)


__all__ = ["TrainState", "default_optimizer", "make_train_step",
           "make_decode_step", "make_prefill", "MeshParams",
           "place_train_state", "gather_train_state", "tree_from_named",
           "abstract_params", "abstract_train_state", "input_specs",
           "cell_config", "lower_cell", "Lowered", "Compiled",
           "MemoryAnalysis"]
