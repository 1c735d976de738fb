"""Training entry point (the port of ``repro.launch.train``).

CPU-scale run (reduced config, real execution):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --reduced --steps 30 --batch 8 --seq 64 --device cpu --resume auto

On the card drop ``--device``; ``--arch mamba2-1.3b`` trains the full
config (1.3e9 parameters, AdamW: ~22 GB of parameters, moments and
gradients). Checkpoints go to ``--ckpt-dir`` (default a folder under the
temporary directory); ``--save-every 0`` writes none.

``--mesh DATAxMODEL`` trains on a mesh of that shape over the machine's
first cards, or over ``--mesh-devices`` (a list may repeat a device:
``cuda:0,cuda:0,cuda:0,cuda:0`` or ``cpu,cpu,cpu,cpu`` for 2x2 on one
device; ``--device`` then defaults to the first one). The step function,
the losses and the checkpoint layout are those of ``1x1``
(``launch.steps``): the state lives placed by the sharding rules, and
checkpoints are written whole, so a mesh run resumes on ``1x1`` and the
other way round.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models.model import init_params
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.runtime import Supervisor
from .mesh import make_mesh
from .steps import (TrainState, gather_train_state, make_train_step,
                    place_train_state)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--save-every", type=int, default=10,
                    help="checkpoint every N steps and at the end; 0: "
                    "never")
    ap.add_argument("--resume", default="fresh", choices=["fresh", "auto"])
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL, e.g. 2x2")
    ap.add_argument("--mesh-devices", default=None, dest="mesh_devices",
                    help="comma-separated devices of the mesh positions "
                    "(may repeat one); default the machine's first cards")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    return ap


def main(argv=None) -> dict:
    """Train ``--steps`` steps; returns the final loss, every step's
    loss and synchronized seconds (batch to metrics, no checkpoint), the
    final state and the config."""
    args = build_parser().parse_args(argv)
    dshape = tuple(int(x) for x in args.mesh.split("x"))
    if len(dshape) != 2 or min(dshape) < 1:
        raise SystemExit(f"--mesh must be DATAxMODEL, got {args.mesh!r}")
    on_mesh = int(np.prod(dshape)) > 1
    mesh_devices = args.mesh_devices.split(",") if args.mesh_devices \
        else None
    if args.device is None and mesh_devices:
        args.device = mesh_devices[0]
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    mesh = None
    if on_mesh:
        mesh = make_mesh(dshape, ("data", "model"), devices=mesh_devices)
        cfg = dataclasses.replace(cfg, batch_axes=("data",))

    optimizer = make_optimizer(
        args.optimizer, warmup_cosine(args.lr, max(args.steps // 10, 1),
                                      args.steps))
    pipe = TokenPipeline(vocab=cfg.vocab, batch=args.batch, seq=args.seq,
                         seed=args.seed)

    devices = {dev} if mesh is None else \
        {dev} | {torch.device(d) for d in mesh.devices.flat}

    def sync():
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    params = init_params(torch.Generator(device=dev).manual_seed(args.seed),
                         cfg)
    state = TrainState(params, optimizer.init(params))
    step_fn = make_train_step(cfg, optimizer, mesh=mesh)

    sup = Supervisor(args.ckpt_dir, save_every=max(args.save_every, 1),
                     heartbeat_path=args.ckpt_dir + "/heartbeat.json")
    start = 0
    if args.resume == "auto":
        restored, start = sup.restore(state)
        if restored is not None:
            state = restored
            print(f"[train] resumed from step {start}")
    if mesh is not None:
        state = place_train_state(state, mesh)
        del params

    def whole():
        return gather_train_state(state, dev)

    losses, step_s = [], []
    sync()
    for step in range(start, args.steps):
        t0 = time.perf_counter()
        batch = {"tokens": torch.from_numpy(
            pipe.batch_at(step)["tokens"]).to(dev)}
        if cfg.frontend == "vision":
            gen = torch.Generator(device=dev).manual_seed(step)
            batch["vision_embeds"] = torch.randn(
                (args.batch, cfg.vision_tokens, cfg.vision_dim),
                generator=gen, device=dev).to(torch.bfloat16)
        state, metrics = step_fn(state, batch)
        values = {k: float(v) for k, v in metrics.items()}   # syncs
        dt = time.perf_counter() - t0
        sup.monitor.observe(step, dt)
        losses.append(values["loss"])
        step_s.append(dt)
        sup.heartbeat(step, values)
        if step % args.log_every == 0:
            print(f"[train] step {step} loss={values['loss']:.4f}"
                  f" ce={values['ce']:.4f}"
                  f" gnorm={values['grad_norm']:.3f}")
        if args.save_every > 0 and (step + 1) % args.save_every == 0:
            sup.maybe_save(step + 1, whole())
    if args.save_every > 0:
        sup.finalize(args.steps, whole())
    final = losses[-1] if losses else float("nan")
    print(f"[train] done; final loss {final:.4f}; checkpoints in "
          f"{args.ckpt_dir}")
    return {"final_loss": final, "losses": losses, "step_s": step_s,
            "start": start, "state": state, "cfg": cfg}


if __name__ == "__main__":
    main()
