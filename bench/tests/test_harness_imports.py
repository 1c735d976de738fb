"""What each part of the benchmark loads: neither the harness nor the
reference loads JAX or the JAX package (top-level names compared whole:
``repro_torch`` is the port), the reference and the control load nothing
of the port, and the runner refuses to run without a card."""
import ast
import json
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
JAX_BENCH = "bench" + "marks/"     # the JAX package's benchmark folder

PROBE = """
import json, sys
sys.path[:0] = [{bench!r}, {src!r}]
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _loaded(body):
    code = PROBE.format(bench=str(BENCH), src=str(ROOT / "src"), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_and_control_load_no_program():
    top = _loaded("import benchlib.reference, benchlib.work, control")
    assert not top & (FORBIDDEN | {"repro_torch"})


def test_harness_running_the_port_loads_no_jax():
    body = """
import functools, time, torch
from benchlib.cell import run_cell
from benchlib.spec import BENCH_DIR, Cell, load_part
PortSystem = load_part(BENCH_DIR, "systems", "repro_torch_spmv").System
cfg = {"generator": "road_grid", "params": {"n": 400, "width": 20,
       "nnz": 966}, "system": "repro_torch_spmv", "algorithm": "parcrs",
       "max_batch": 32, "pad_pow2": True, "dtype": "float32",
       "check": {"max_norm_err": 1e-4}}
tr = {"loop": "closed", "clients": 8, "warmup_flushes": 1,
      "trace_flushes": 4, "check_samples": 4}
out = run_cell(Cell("t", 1, cfg, tr, [], []), seed=1, seconds=0.1,
               trace=True, device="cpu", t_start=time.perf_counter(),
               system_factory=functools.partial(PortSystem, impl="plain"))
assert out.correct
"""
    top = _loaded(body)
    assert "repro_torch" in top
    assert not top & FORBIDDEN


def test_no_file_of_the_benchmark_imports_or_reads_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = {node.module.split(".")[0]}
            else:
                tops = set()
            assert not tops & FORBIDDEN, (path, tops)
            if isinstance(node, ast.Constant) and isinstance(node.value,
                                                             str):
                assert not node.value.startswith(JAX_BENCH), path


def test_runner_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "road-parcrs.clients1", "--seed", "2147483659", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=str(ROOT), env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert "{" not in out.stdout
