"""At the tests' sizes on the CPU, the plain reference agrees with the
port: its H with the program's operator, its levels with a dense
``eigh``, and each cell's solves with its own comparison."""

import numpy as np
import pytest
import torch

from benchmark.configs import ch3cn6, ch3cn6_program, ch3cn6_ref
from benchmark.harness import core, spec

from .conftest import small_sizes

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def test_ch3cn6_reference_against_port(cpu):
    inp = ch3cn6.Inputs(small_sizes("ch3cn6"))
    ref = ch3cn6.reference(inp, cpu)
    op = ch3cn6_program.operator(inp, cpu)
    X = torch.randn(2, inp.n, dtype=torch.float64)
    assert torch.allclose(op.matvec_lanes(X), ref.apply(X), rtol=0,
                          atol=1e-12 * ref.h_norm)
    # what writes the card's levels, against the dense eigh
    levels, res, _ = ch3cn6_ref.lowest_levels(ref.apply, inp.n, 4, cpu)
    assert np.allclose(levels, ref.levels(4), rtol=1e-12)
    assert (res < 1e-12).all()
    h_norm = ch3cn6_ref.largest_magnitude(ref.apply, inp.n, cpu)
    assert h_norm == pytest.approx(ref.h_norm, rel=1e-10)


@pytest.mark.parametrize("cell", CELLS)
def test_port_solves_agree_with_reference(cell, cpu):
    """Solves from three seeds' guesses converge, and their eigenpairs
    are the reference's at the tests' size, to the cell's own eConv."""
    c = core.Cell(cell, device=cpu, sizes=small_sizes(cell.split(".")[0]))
    recs = [c.solve(seed, 0) for seed in (1, 2 ** 31 + 11, 7_000_000_003)]
    _, _, per = c.judge(recs)
    assert all(r["converged"] for r in recs)
    for r in per:
        assert r["ev_rel_err"] < 1e-8
        assert r["residual"] < 1e-4
        assert r["rq_gap"] < 1e-5
        assert r.get("count_gap", 0) == 0
