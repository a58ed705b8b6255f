"""CPU tests of the benchmark: run from the repository root,
``python -m pytest benchmark/tests -q``."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def small_sizes(config):
    """The configuration's sizes with its own ``tests.sizes`` over them:
    small enough for a CPU, every mix's levels still there."""
    from benchmark.harness import spec
    sizes = spec.config_sizes(spec.benchmark(), config)
    sizes.update(sizes["tests"]["sizes"])
    return sizes


def config_of(cell):
    """The configuration that ``cell`` runs, as BENCHMARK.json names it."""
    from benchmark.harness import spec
    return spec.cell(spec.benchmark(), cell)["config"]


@pytest.fixture
def cpu():
    import torch
    return torch.device("cpu")
