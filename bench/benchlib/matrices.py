"""The benchmark's matrices: a configuration's ``generator`` names a matrix
class in ``generators/<name>.py``, drawn on the run's device from one
seeded ``torch.Generator`` in a few large calls, with the configuration's
``params``. Later changes to the program's generators do not reach the
benchmark, and a new class is a new file.

Every generator returns host numpy triplets ``(rows int32, cols int32,
vals float32, (m, n))``: the benchmark hands the same triplets to the
program (its ``to_coo``) and, after the window, to the reference.
"""
from __future__ import annotations

from pathlib import Path

import torch

from .spec import BENCH_DIR, load_part


def to_host(rows, cols, vals, shape):
    """Device index and value tensors as the host triplets of a generator."""
    return (rows.to(torch.int32).cpu().numpy(),
            cols.to(torch.int32).cpu().numpy(),
            vals.to(torch.float32).cpu().numpy(), tuple(shape))


def generate(config: dict, seed: int, device,
             bench_dir: Path = BENCH_DIR) -> tuple:
    """The configuration's matrix for ``seed``: its ``generator`` class
    with its ``params``."""
    gen = load_part(bench_dir, "generators", config["generator"])
    g = torch.Generator(device=device)
    g.manual_seed(matrix_seed(seed))
    return gen.generate(g, device, **config["params"])


def matrix_seed(seed: int) -> int:
    """The matrix's generator seed; the requests' is ``request_seed``. The
    two never coincide, whatever the seeds."""
    return (2 * int(seed)) % 2 ** 64


def request_seed(seed: int) -> int:
    return (2 * int(seed) + 1) % 2 ** 64


__all__ = ["to_host", "generate", "matrix_seed", "request_seed"]
