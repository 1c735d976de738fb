"""Serving example: batched requests, prefill + cached greedy decode on
the reduced hybrid (jamba-style) model — attention KV caches and SSM
states in the same cache list, MoE layers through K9 on the card (the
per-expert route on the CPU).

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu
      PYTHONPATH=src python -m repro_torch.examples.serve_lm   # the card
"""
from __future__ import annotations

import argparse

from repro_torch.launch import serve as serve_cli


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default cuda")
    args = ap.parse_args(argv)
    extra = ["--device", args.device] if args.device else []
    res = serve_cli.main(["--mode", "lm", "--arch", "jamba-1.5-large-398b",
                          "--reduced", "--batch", "4", "--prompt-len", "24",
                          "--gen", "12"] + extra)
    print(f"[example] generated shape {res['tokens'].shape}")
    print("serve_lm OK")
    return res


if __name__ == "__main__":
    main()
