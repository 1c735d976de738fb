"""setup_s: from the harness's start to the first timed submit: imports,
CUDA initialisation, the kernels' load (or build), the matrix, the port's
conversion and the warm-up of the cell's own batch shapes (host clock)."""


def read(run):
    return run.setup_s if run.window is not None else None
