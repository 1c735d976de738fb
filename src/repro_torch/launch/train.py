"""Training entry point (the port of ``repro.launch.train``): one card.

CPU-scale run (reduced config, real execution):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --reduced --steps 30 --batch 8 --seq 64 --device cpu --resume auto

On the card drop ``--device``; ``--arch mamba2-1.3b`` trains the full
config (1.3e9 parameters, AdamW: ~22 GB of parameters, moments and
gradients). ``--mesh`` other than 1x1 waits for the LM mesh slice
(ROADMAP.md queue 1 item 5). Checkpoints go to ``--ckpt-dir`` (default a
folder under the temporary directory).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models.model import init_params
from repro_torch.optim import make_optimizer, warmup_cosine
from repro_torch.runtime import Supervisor
from .steps import TrainState, make_train_step


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
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--resume", default="fresh", choices=["fresh", "auto"])
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL; only 1x1 (one device) for now")
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
    if args.mesh != "1x1":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the LM mesh (shardings, build_mesh) is "
            "ROADMAP.md queue 1 item 5; the port trains on one device")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)

    optimizer = make_optimizer(
        args.optimizer, warmup_cosine(args.lr, max(args.steps // 10, 1),
                                      args.steps))
    pipe = TokenPipeline(vocab=cfg.vocab, batch=args.batch, seq=args.seq,
                         seed=args.seed)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    params = init_params(torch.Generator(device=dev).manual_seed(args.seed),
                         cfg)
    state = TrainState(params, optimizer.init(params))
    step_fn = make_train_step(cfg, optimizer)

    sup = Supervisor(args.ckpt_dir, save_every=args.save_every,
                     heartbeat_path=args.ckpt_dir + "/heartbeat.json")
    start = 0
    if args.resume == "auto":
        restored, start = sup.restore(state)
        if restored is not None:
            state = restored
            print(f"[train] resumed from step {start}")

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
        sup.maybe_save(step + 1, state)
    sup.finalize(args.steps, state)
    final = losses[-1] if losses else float("nan")
    print(f"[train] done; final loss {final:.4f}; checkpoints in "
          f"{args.ckpt_dir}")
    return {"final_loss": final, "losses": losses, "step_s": step_s,
            "start": start, "state": state, "cfg": cfg}


if __name__ == "__main__":
    main()
