"""The control of the check that decides ``correct``: the reference, put
in the program's place and computed in bfloat16, the precision below the
configurations' float32. Its answers have to come out as not correct.

    python3 bench/control.py --workloads <cell>[,<cell>] --seeds 11,12,13 \
        [--seconds 2]

Drives each cell's closed loop as a run does, for a short window at the
cell's own size and load, with a plain queue and the bfloat16 reference in
place of the batcher and the operator, and prints each seed's largest
normalised error beside the cell's limit; the last line is a JSON list.
The benchmark's own runs never run it.
"""
import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH)]

import torch  # noqa: E402

from benchlib.cell import run_cell  # noqa: E402
from benchlib.reference import Reference  # noqa: E402
from benchlib.spec import load_cell  # noqa: E402


class ControlQueue:
    """The batcher's contract (``submit``, ``pending``, ``flush``) over the
    control's multiply: up to ``max_batch`` requests a flush, no padding."""

    def __init__(self, multiply, max_batch: int):
        self.multiply = multiply
        self.max_batch = max_batch
        self._queue = []
        self._next = 0

    @property
    def pending(self) -> int:
        return len(self._queue)

    def submit(self, x):
        rid = self._next
        self._next += 1
        self._queue.append((rid, x))
        return rid

    def flush(self):
        batch = self._queue[:self.max_batch]
        self._queue = self._queue[self.max_batch:]
        Y = self.multiply(torch.stack([x for _, x in batch], dim=1))
        return {rid: Y[:, j] for j, (rid, _) in enumerate(batch)}


class ControlSystem:
    """The reference in bfloat16 in the program's place."""

    def __init__(self, config, triplets, device):
        t0 = time.perf_counter()
        self.ref = Reference(triplets, device, dtype=torch.bfloat16)
        self.max_batch = int(config["max_batch"])
        self.convert_s = time.perf_counter() - t0

    def multiply(self, X):
        return self.ref.matmul(X).to(torch.float32)

    def batcher(self, annotate=False):
        return ControlQueue(self.multiply, self.max_batch)

    def close(self):
        self.ref = None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workloads", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    rows = []
    for name in args.workloads.split(","):
        cell = load_cell(name)
        for seed in (int(s) for s in args.seeds.split(",")):
            out = run_cell(cell, seed=seed, seconds=args.seconds, trace=False,
                           device="cuda:0", t_start=time.perf_counter(),
                           system_factory=ControlSystem)
            row = {"workload": name, "seed": seed, "correct": out.correct,
                   "samples": len(out.errors), "max_norm_err": out.max_error,
                   "min_norm_err": min(out.errors, default=None),
                   "limit": out.limit}
            print(f"control {name} seed {seed}: max_norm_err "
                  f"{out.max_error:.4g} (limit {out.limit:.4g}), min over "
                  f"{len(out.errors)} samples {row['min_norm_err']:.4g}, "
                  f"correct {out.correct}", flush=True)
            rows.append(row)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
