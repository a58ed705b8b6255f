"""The bound of one apply reproduces the hand count of the CH3CN cut's
useful flops (at N = 14, 21.10 GFLOP an apply)."""

import json

import pytest

from benchmark.configs import ch3cn6
from benchmark.harness import peaks
from benchmark.harness.spec import ROOT


def test_ch3cn6_flops_and_bound():
    sizes = json.loads((ROOT / "benchmark/configs/ch3cn6.json").read_text())
    inp = ch3cn6.Inputs(dict(sizes, N=14))
    assert inp.n == 7_529_536 and len(inp.terms) == 65
    assert ch3cn6.apply_flops(inp) / 1e9 == pytest.approx(21.10, abs=0.005)
    t = ch3cn6.apply_bound_s(inp, 1, "f64")
    assert t * 1e3 == pytest.approx(0.3149, abs=5e-5)
    # the flops bound it, not the bytes (0.036 ms)
    assert 2 * inp.n * 8 / peaks.HBM_BPS < t
    assert ch3cn6.apply_bound_s(inp, 3, "f64") == pytest.approx(3 * t)

