"""``BENCHMARK.json`` and the files it names: each cell's configuration
(sizes and modules), traffic mix, the mix's entry point and picks, limits,
and each per-layer metric's reader, all found by name under the
benchmark's folder."""

import importlib
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def read_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return read_json(Path(root) / "BENCHMARK.json")


def cell(bench, name):
    """The ``workloads`` entry called ``name``."""
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(bench, name):
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def config_sizes(bench, name):
    """The configuration's file of sizes, as it is run."""
    return read_json(ROOT / config(bench, name)["file"])


def config_module(name, part=""):
    """``configs/<name><part>.py``: "" the inputs and traffic hooks,
    "_program" the system under test's operator, "_ref" the reference."""
    return importlib.import_module(f"benchmark.configs.{name}{part}")


def traffic(name):
    return read_json(BENCH_DIR / "traffic" / f"{name}.json")


def entry(name):
    """``entries/<name>.py``'s ``solve``."""
    return importlib.import_module(f"benchmark.entries.{name}").solve


def pick(name):
    """``picks/<name>.py``'s ``pick``."""
    return importlib.import_module(f"benchmark.picks.{name}").pick


def limits(cell_name):
    return read_json(BENCH_DIR / "limits" / f"{cell_name}.json")


def metric_reader(name):
    """``metrics/<name>.py``'s ``read(record)``."""
    return importlib.import_module(f"benchmark.metrics.{name}").read


def metrics_of(bench, cell_name, kind):
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell_name``
    reports: those without a ``workloads`` key, and those that list it."""
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]
