"""BENCHMARK.json keeps to its contract, every file a cell needs is
found by name, and a second configuration with its cell enters by new
files and entries alone."""

import copy
import json
import re
import shutil
import sys

import pytest

from benchmark.harness import core, spec

from .conftest import small_sizes

B = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LAYERS = {"drivers", "solve loop", "operators & kernels", "device"}


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "benchmark/run.py"]
    assert B["paths"] == ["benchmark"]
    assert 1 <= B["run_seconds"] <= 51
    assert len(json.dumps(B)) < 64 * 1024


def test_names_and_units():
    names = [c["name"] for c in B["configs"]] + [
        w["name"] for w in B["workloads"]] + [
        m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in B["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["chips"] in (1, 4)


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert set(e2e) == {"solve_s", "peak_mem_gib", "setup_s"}
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_per_layer_metrics():
    e2e = {m["name"] for m in B["end_to_end"]}
    cells = {w["name"] for w in B["workloads"]}
    for m in B["per_layer"]:
        assert m["moves"] in e2e
        assert m["layer"] in LAYERS
        assert set(m["workloads"]) <= cells
        assert callable(spec.metric_reader(m["name"]))


@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
def test_cell_files_found_by_name(cell):
    w = spec.cell(B, cell)
    cfg = spec.config(B, w["config"])
    sizes = spec.config_sizes(B, w["config"])
    assert cfg["file"].startswith("benchmark/")
    for key in cfg["reduced"]:
        assert key in sizes and NAME.match(key)
    assert sizes["tests"]["sizes"]
    for part in ("", "_program", "_ref"):
        assert spec.config_module(w["config"], part)
    hooks = spec.config_module(w["config"])
    for fn in ("inputs", "traffic_inputs", "guesses", "apply_bound_s",
               "reference"):
        assert callable(getattr(hooks, fn))
    program = spec.config_module(w["config"], "_program")
    for fn in ("operator", "port_applies"):
        assert callable(getattr(program, fn))
    traffic = spec.traffic(w["traffic"])
    # the mix's entry point and picks: files of their own, found by name
    assert callable(spec.entry(traffic["entry"]))
    assert callable(spec.pick(traffic["targets"]["pick"]))
    limits = spec.limits(cell)
    assert limits and limits["unconverged"] == 0
    reported = {m["name"] for m in spec.metrics_of(B, cell, "end_to_end")}
    assert "setup_s" in reported and len(reported) >= 2
    assert spec.metrics_of(B, cell, "per_layer")


def test_every_config_used():
    used = {w["config"] for w in B["workloads"]}
    assert used == {c["name"] for c in B["configs"]}


def test_second_config_enters_by_files_alone(monkeypatch, tmp_path, cpu):
    """A stand-in configuration under another name (the first one's
    modules under that name, its sizes file with tests' sizes of its
    own) and a cell of it whose name does not start with the
    configuration's, with its limits file: found, sized, built, solved and
    judged with no file of the repository edited."""
    first = B["workloads"][0]
    name, cell = "stand_in", "probe.second"
    for part in ("", "_program", "_ref"):
        monkeypatch.setitem(sys.modules, f"benchmark.configs.{name}{part}",
                            spec.config_module(first["config"], part))
    sizes = dict(spec.config_sizes(B, first["config"]), name=name)
    sizes["tests"] = {"sizes": dict(sizes["tests"]["sizes"], nModes=5),
                      "why": "the stand-in's own: five modes"}
    (tmp_path / f"{name}.json").write_text(json.dumps(sizes))
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(spec.BENCH_DIR / "traffic", bench_dir / "traffic")
    (bench_dir / "limits").mkdir()
    shutil.copy(spec.BENCH_DIR / "limits" / f"{first['name']}.json",
                bench_dir / "limits" / f"{cell}.json")
    bench = copy.deepcopy(B)
    bench["configs"].append(dict(spec.config(B, first["config"]), name=name,
                                 file=str(tmp_path / f"{name}.json")))
    bench["workloads"].append(dict(first, name=cell, config=name))
    monkeypatch.setattr(spec, "benchmark", lambda root=None: bench)
    monkeypatch.setattr(spec, "BENCH_DIR", bench_dir)

    small = small_sizes(name)
    assert small["nModes"] == 5 and small["N"] == sizes["tests"]["sizes"]["N"]
    c = core.Cell(cell, device=cpu, sizes=small)
    assert c.inp.n == small["N"] ** 5
    rec = c.solve(4_000_000_007, 0)
    numbers, failed, _ = c.judge([rec])
    assert rec["converged"] and failed == 0, numbers
    assert rec["counts"]["es.apply"]["calls"] == rec["port_applies"]
