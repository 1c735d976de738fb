"""End-to-end driver (the port of ``examples/train_lm.py``): train a
~100M-parameter dense LM for a few hundred steps on the synthetic
bigram-structured pipeline and watch the loss fall well below the
unigram entropy, then train a sparse graph-mixer head whose backward pass
runs through one ``repro_torch.spmm.SparseOperator`` (forward ``A @ h``
through the installed plan, cotangent ``A^T g`` through the same plan's
transpose multiply — no dense A, ever).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm --small \\
          --device cpu --impl plain      # ~8M params, the kernels' plain
                                         # versions in the sparse phase
      PYTHONPATH=src python -m repro_torch.examples.train_lm   # the card
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch


def lm_phase(steps: int, small: bool, device) -> float:
    """The LM training through ``launch.train``; returns the final loss."""
    import repro_torch.configs.llama3_2_1b as mod
    from repro_torch.launch import train as train_cli
    from repro_torch.models.model import ModelConfig

    ckpt = os.path.join(tempfile.gettempdir(), "repro_torch_train_lm_ckpt")
    extra = ["--ckpt-dir", ckpt, "--save-every", "50"]
    if device is not None:
        extra += ["--device", str(device)]
    if small:                                                  # ~8M params
        return train_cli.main(
            ["--arch", "llama3.2-1b", "--reduced",
             "--steps", str(min(steps, 60)), "--batch", "8", "--seq", "64",
             "--lr", "3e-3"] + extra)["final_loss"]
    # ~100M params: the CLI takes registered configs, so the llama file's
    # REDUCED slot holds this one for the run
    cfg100 = ModelConfig(
        name="llama-100m", n_layers=8, d_model=512, n_heads=8, kv_heads=4,
        d_ff=2048, vocab=32768, head_dim=64, tie_embeddings=True,
        block_pattern=("attn",), mlp_pattern=("dense",),
        compute_dtype=torch.float32, loss_chunk=64)
    reduced, mod.REDUCED = mod.REDUCED, cfg100
    try:
        return train_cli.main(
            ["--arch", "llama3.2-1b", "--reduced", "--steps", str(steps),
             "--batch", "8", "--seq", "128", "--lr", "1e-3",
             "--log-every", "10"] + extra)["final_loss"]
    finally:
        mod.REDUCED = reduced


def sparse_mixer_phase(device=None, impl: str = "auto") -> dict:
    """60 steps of gradient descent on ``mean((A F w - A F w_true)^2)``
    with A an RMAT graph (scale 9) normalized by in-degree, through
    ``sparse_matmul``:
    each step's forward runs the operator's installed plan, its backward
    the plan's transpose multiply. Returns the first and last loss, every
    step's loss, the plan, the operator and its stats."""
    from repro_torch.core import PlanSpec, resolve_device, to_coo
    from repro_torch.data import matrices
    from repro_torch.spmm import SparseOperator, sparse_matmul

    dev = resolve_device(device)
    g_rows, g_cols, _, g_shape = matrices.rmat(scale=9, edge_factor=8,
                                               seed=3)
    n_nodes = g_shape[0]
    deg = np.bincount(g_cols, minlength=n_nodes).astype(np.float32)
    A = SparseOperator.from_coo(
        to_coo(g_rows, g_cols, 1.0 / np.maximum(deg[g_cols], 1.0), g_shape,
               device=dev),
        PlanSpec(num_devices=1), impl=impl, k_hint=16, num_spmvs=200)

    rng = np.random.default_rng(0)
    d_feat, d_out = 32, 16

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    feats = t(rng.standard_normal((n_nodes, d_feat)))
    w_true = t(rng.standard_normal((d_feat, d_out)))
    with torch.no_grad():
        targets = sparse_matmul(A, feats @ w_true)     # realizable optimum

        # step size 1/L via power iteration on the quadratic's Hessian map
        # H(v) = 2/(n·d_out) · F^T A^T A F v — four operator multiplies
        v = t(rng.standard_normal((d_feat, d_out)))
        for _ in range(8):
            v = v / torch.linalg.norm(v)
            hv = feats.T @ sparse_matmul(A.T, sparse_matmul(A, feats @ v))
            v = 2.0 / (n_nodes * d_out) * hv
        lr = 1.0 / float(torch.linalg.norm(v))

    w = torch.zeros((d_feat, d_out), device=dev)
    losses = []
    for _ in range(60):
        wv = w.clone().requires_grad_(True)
        loss = torch.mean((sparse_matmul(A, feats @ wv) - targets) ** 2)
        (g,) = torch.autograd.grad(loss, wv)       # bwd: A^T g via rmatmul
        losses.append(float(loss.detach()))
        w = w - lr * g
    return {"loss0": losses[0], "loss": losses[-1], "losses": losses,
            "plan": f"{A.plan.label}/{A.plan.impl}", "op": A,
            "stats": A.stats}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true",
                    help="8M params / fewer steps (CI-friendly)")
    ap.add_argument("--device", default=None, help="default cuda")
    ap.add_argument("--impl", default="auto",
                    help="the sparse phase's operator impl (auto, plain, "
                         "ref, kernel)")
    args = ap.parse_args(argv)

    final_loss = lm_phase(args.steps, args.small, args.device)
    print(f"[example] final loss: {final_loss:.3f}")

    print("[example] sparse-mixer phase: backward via the operator "
          "transpose")
    res = sparse_mixer_phase(args.device, args.impl)
    print(f"[example] sparse-mixer loss {res['loss0']:.4f} -> "
          f"{res['loss']:.4f} ({res['stats'].multiplies} operator "
          f"multiplies, plan {res['plan']})")
    assert res["loss"] < 0.1 * res["loss0"], \
        "sparse backward failed to learn"
    print("[example] sparse backward through the operator OK")
    return {"final_loss": final_loss, **res}


if __name__ == "__main__":
    main()
