"""The control of the check: the bfloat16 reference in the program's
place fails each configuration's limit, while the program's plain path
(the kernels' plain PyTorch versions, float32) passes it, at a size the
CPU holds. The readings at the cells' own sizes come from
``bench/control.py`` on the card (PERF.md)."""
import pytest

from conftest import run_tiny, tiny_cell
from control import ControlSystem


@pytest.mark.parametrize("gen,clients", [("uniform", 64), ("road_grid", 64),
                                         ("road_grid", 1)])
def test_control_fails_and_program_passes(gen, clients):
    cell = tiny_cell(gen, clients)
    limit = cell.config["check"]["max_norm_err"]
    ctl = run_tiny(cell, system_factory=ControlSystem)
    assert not ctl.correct
    assert ctl.max_error > 10 * limit
    prog = run_tiny(cell)
    assert prog.correct, prog.checks()
    assert prog.max_error < limit / 10
