"""Finding a cell's configuration, traffic mix, metric readers, matrix
class, system and loop from files, for the committed cells and for one
added from a temporary directory without editing a file that is there."""
import functools
import json
import re
import shutil
import time

import numpy as np
import pytest

from benchlib.cell import run_cell
from benchlib.spec import load_cell, load_part, load_reader
from conftest import BENCH, ROOT, PortSystem

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_committed_cell_resolves(cell):
    c = load_cell(cell)
    assert c.chips == 1
    assert c.traffic["loop"] == "closed" and c.traffic["clients"] >= 1
    assert c.config["algorithm"] in ("sellcs", "parcrs")
    # every cell reports the same quantities under the same names
    assert {m.name for m in c.end_to_end} == {
        "requests_per_s", "latency_p95_ms", "setup_s"}
    assert {m.name for m in c.per_layer} == {
        "convert_s", "pad_ms", "multiply_ms", "spmm_roofline",
        "device_idle_pct", "step_mfu_pct"}
    assert all(callable(m.read) for m in c.end_to_end + c.per_layer)
    # the code the configuration and the mix name is found by name
    assert callable(load_part(c.bench_dir, "generators",
                              c.config["generator"]).generate)
    assert callable(load_part(c.bench_dir, "systems",
                              c.config["system"]).System)
    assert callable(load_part(c.bench_dir, "loops", c.traffic["loop"]).run)


@pytest.mark.parametrize("name", ["cage15-sellcs", "road_usa-parcrs"])
def test_configurations_run_their_source_at_its_size(name):
    """No scale is cut: the rows and nnz are the published matrix's, and
    the generator's parameters give exactly those."""
    b = _bench()
    entry = next(c for c in b["configs"] if c["name"] == name)
    cfg = json.load(open(ROOT / entry["file"]))
    assert entry["reduced"] == [] and cfg["reduced"] == {}
    pub = cfg["published"]
    assert cfg["rows"] == pub["rows"] and cfg["nnz"] == pub["nnz"]
    assert cfg["nnz"] / cfg["rows"] == pytest.approx(pub["nnz_per_row"],
                                                     abs=0.005)
    p = cfg["params"]
    if cfg["generator"] == "uniform":
        assert (p["m"], p["n"], p["nnz"]) == (pub["rows"], pub["cols"],
                                             pub["nnz"])
    else:
        edges = load_part(BENCH, "generators", "road_grid").edge_counts
        horizontal, candidates = edges(p["n"], p["width"])
        assert p["n"] == pub["rows"] and p["nnz"] == pub["nnz"]
        assert 0 <= p["nnz"] // 2 - horizontal <= candidates


def test_benchmark_names_and_moves():
    b = _bench()
    e2e = {m["name"] for m in b["end_to_end"]}
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in b[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        moved = next(x for x in b["end_to_end"] if x["name"] == m["moves"])
        # each cell of a per-layer metric reports the metric it moves
        assert set(m["workloads"]) <= set(
            moved.get("workloads", m["workloads"]))
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for c in b["configs"]:
        cfg = json.load(open(ROOT / c["file"]))
        assert set(c["reduced"]) <= set(cfg["reduced"])
        assert len(cfg["source"]) <= 200


def test_cell_added_from_files_alone(tmp_path):
    """A new configuration, mix and per-layer metric are files plus
    entries; the harness finds them by name."""
    bench_dir = tmp_path / "bench"
    for sub in ("configs", "traffic", "metrics", "generators", "systems",
                "loops"):
        shutil.copytree(BENCH / sub, bench_dir / sub)
    b = _bench()
    # a new matrix class: a band of three diagonals
    (bench_dir / "generators" / "tridiagonal.py").write_text(
        "import torch\n"
        "from benchlib.matrices import to_host\n"
        "def generate(g, device, *, m):\n"
        "    i = torch.arange(m, device=device)\n"
        "    r = torch.cat([i, i[1:], i[:-1]])\n"
        "    c = torch.cat([i, i[1:] - 1, i[:-1] + 1])\n"
        "    v = torch.randn(r.numel(), generator=g, device=device)\n"
        "    return to_host(r, c, v, (m, m))\n")
    cfg = json.load(open(BENCH / "configs" / "cage15-sellcs.json"))
    cfg["name"] = "tridiag-sellcs"
    cfg["generator"] = "tridiagonal"
    cfg["params"] = {"m": 3000}
    (bench_dir / "configs" / "tridiag-sellcs.json").write_text(
        json.dumps(cfg))
    (bench_dir / "traffic" / "clients8.json").write_text(json.dumps(
        {"loop": "closed", "clients": 8, "warmup_flushes": 2,
         "trace_flushes": 10, "check_samples": 4}))
    (bench_dir / "metrics" / "answers_per_flush.py").write_text(
        "def read(run):\n"
        "    s = run.stretch\n"
        "    return None if s is None else sum(s.flush_ks) / len(s.flush_ks)\n")
    b["configs"].append({"name": "tridiag-sellcs", "source": "x",
                         "file": "bench/configs/tridiag-sellcs.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "hhh8.clients8",
                           "config": "tridiag-sellcs",
                           "traffic": "clients8", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "answers_per_flush", "unit": "requests",
                           "better": "higher", "source": "program_counter",
                           "layer": "batcher", "moves": "requests_per_s",
                           "workloads": ["hhh8.clients8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    c = load_cell("hhh8.clients8", root=tmp_path, bench_dir=bench_dir)
    assert c.config["params"]["m"] == 3000
    assert c.traffic["clients"] == 8
    assert [m.name for m in c.per_layer] == ["answers_per_flush"]
    out = run_cell(c, seed=2 ** 31 + 3, seconds=0.2, trace=False,
                   device="cpu", t_start=time.perf_counter(),
                   system_factory=functools.partial(PortSystem,
                                                    impl="plain"))
    assert out.correct, out.checks()
    assert out.run.nnz == 3 * 3000 - 2
    assert np.isfinite(out.max_error)

    class S:
        flush_ks = [8, 8, 4]
    assert c.per_layer[0].read(type("R", (), {"stretch": S})()) == 20 / 3
    # the committed cells are untouched by the addition
    old = load_cell("road-parcrs.clients1", root=tmp_path,
                    bench_dir=bench_dir)
    assert "answers_per_flush" not in [m.name for m in old.per_layer]


def test_missing_parts_are_named():
    with pytest.raises(KeyError, match="no workload"):
        load_cell("no-such.cell")
    with pytest.raises(FileNotFoundError, match="no reader"):
        load_reader(BENCH, "no_such_metric")
