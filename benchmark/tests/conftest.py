"""CPU tests of the benchmark: run from the repository root,
``python -m pytest benchmark/tests -q``."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# The tests' sizes: small enough for a CPU, every mix's levels still there.
SMALL = {"ch3cn6": {"N": 3}}


def small_sizes(config):
    sizes = json.loads((ROOT / "benchmark" / "configs"
                        / f"{config}.json").read_text())
    sizes.update(SMALL[config])
    return sizes


@pytest.fixture
def cpu():
    import torch
    return torch.device("cpu")
