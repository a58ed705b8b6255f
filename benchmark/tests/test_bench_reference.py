"""At the tests' sizes on the CPU, the plain reference agrees with the
port: each configuration's H with the program's operator, CH3CN's levels
with a dense ``eigh``, and each cell's solves with its own comparison."""

import numpy as np
import pytest
import torch

from benchmark.harness import core, spec

from .conftest import config_of, small_sizes

B = spec.benchmark()
CELLS = [w["name"] for w in B["workloads"]]
CONFIGS = [c["name"] for c in B["configs"]]


@pytest.mark.parametrize("config", CONFIGS)
def test_reference_against_port(config, cpu):
    """The ``_program`` operator's lane apply is the reference's apply on
    seeded random lanes, in f64."""
    hooks = spec.config_module(config)
    inp = hooks.inputs(small_sizes(config))
    ref = hooks.reference(inp, cpu)
    op = spec.config_module(config, "_program").operator(inp, cpu)
    gen = torch.Generator().manual_seed(2 ** 31 + 7)
    X = torch.randn(2, inp.n, dtype=torch.float64, generator=gen)
    assert torch.allclose(op.matvec_lanes(X), ref.apply(X), rtol=0,
                          atol=1e-12 * ref.h_norm)


def test_ch3cn6_reference_levels(cpu):
    """What writes the card's levels and ‖H‖, against the dense eigh."""
    from benchmark.configs import ch3cn6, ch3cn6_ref
    inp = ch3cn6.Inputs(small_sizes("ch3cn6"))
    ref = ch3cn6.reference(inp, cpu)
    levels, res, _ = ch3cn6_ref.lowest_levels(ref.apply, inp.n, 4, cpu)
    assert np.allclose(levels, ref.levels(4), rtol=1e-12)
    assert (res < 1e-12).all()
    h_norm = ch3cn6_ref.largest_magnitude(ref.apply, inp.n, cpu)
    assert h_norm == pytest.approx(ref.h_norm, rel=1e-10)


@pytest.mark.parametrize("cell", CELLS)
def test_port_solves_agree_with_reference(cell, cpu):
    """Solves from three seeds' guesses converge, and their eigenpairs
    are the reference's at the tests' size, to the cell's own eConv."""
    c = core.Cell(cell, device=cpu, sizes=small_sizes(config_of(cell)))
    recs = [c.solve(seed, 0) for seed in (1, 2 ** 31 + 11, 7_000_000_003)]
    _, _, per = c.judge(recs)
    assert all(r["converged"] for r in recs)
    for r in per:
        assert r["ev_rel_err"] < 1e-8
        assert r["residual"] < 1e-4
        assert r["rq_gap"] < 1e-5
        assert r.get("count_gap", 0) == 0
