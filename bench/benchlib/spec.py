"""Finding a cell's parts by name: its configuration (the file that
``BENCHMARK.json`` names), its traffic mix (``traffic/<name>.json``), the
reader of each of its metrics (``metrics/<name>.py``, a module with
``read(run) -> float | None``), and the code that the configuration and
the mix name: the matrix class (``generators/<generator>.py``), the system
under test (``systems/<system>.py``) and the load (``loops/<loop>.py``).
A later change adds a configuration, a mix, a metric, a matrix class, a
system or a loop as new files and new entries; it edits none of these."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    read: Callable


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]
    bench_dir: Path = BENCH_DIR


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _for_cell(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


_LOADED: Dict[str, ModuleType] = {}


def load_part(bench_dir: Path, kind: str, name: str) -> ModuleType:
    """The module ``bench_dir/<kind>/<name>.py``, loaded once a process."""
    path = (Path(bench_dir) / kind / f"{name}.py").resolve()
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} entry {name!r}: {path}")
    key = str(path)
    if key not in _LOADED:
        tag = name.replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(
            f"bench_{kind}_{tag}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[key] = mod
    return _LOADED[key]


def load_reader(bench_dir: Path, name: str) -> Callable:
    try:
        return load_part(bench_dir, "metrics", name).read
    except FileNotFoundError as e:
        raise FileNotFoundError(f"no reader for metric {name!r}: {e}")


def load_cell(name: str, *, root: Path = ROOT,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its parts read
    from ``bench_dir``."""
    bench = _load_json(Path(root) / "BENCHMARK.json")
    cells: Dict[str, dict] = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(Path(root) / configs[w["config"]]["file"])
    traffic = _load_json(Path(bench_dir) / "traffic" / f"{w['traffic']}.json")

    def metrics(key):
        return [Metric(m["name"], m["unit"], load_reader(bench_dir, m["name"]))
                for m in bench[key] if _for_cell(m, name)]

    return Cell(name, int(w["chips"]), config, traffic,
                metrics("end_to_end"), metrics("per_layer"), Path(bench_dir))
