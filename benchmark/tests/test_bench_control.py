"""The comparison that decides ``correct`` fails what it must: the
control (the program with its own path of the precision below the
configuration's switched on), and a run with the timed path broken
underneath, while a sound run of the same traffic passes."""

import warnings

import numpy as np
import pytest

from benchmark.harness import core, spec

from .conftest import config_of, small_sizes

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SEED = 4_000_000_007
# the numbers that judge an eigenpair (not the solver's own verdict)
EIGENPAIR = ("ev_rel_err", "residual", "rq_gap", "count_gap")


def _over(numbers):
    return [k for k, (v, lim) in numbers.items()
            if k in EIGENPAIR and v > lim]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, cpu):
    c = core.Cell(cell, device=cpu, sizes=small_sizes(config_of(cell)),
                  control=True)
    recs = [c.solve(SEED, i) for i in range(2)]
    numbers, failed, _ = c.judge(recs)
    assert failed == len(recs)
    assert _over(numbers)


class Unchanged(core.Fault):
    """Every apply returns its input: the step leaves the state as it
    was."""

    def wrap(self, op):
        op.matvec = lambda x: x.clone()
        op.matvec_lanes = lambda X: X.clone()
        return op


class HalfLanes(core.Fault):
    """A lane-stack apply leaves out the second half of its lanes."""

    def wrap(self, op):
        full = op.matvec_lanes

        def half(X):
            Y = full(X)
            Y[X.shape[0] - X.shape[0] // 2:] = 0
            return Y
        op.matvec_lanes = half
        return op


class Altered(core.Fault):
    """Each solve's answer altered where it is produced: the eigenvalues
    moved by a part in a thousand."""

    def alter(self, ev, V):
        return np.asarray(ev) * (1 + 1e-3), V


def _faults(cell):
    out = [("unchanged", Unchanged), ("altered", Altered)]
    if spec.traffic(spec.cell(spec.benchmark(), cell)["traffic"])["nguess"] > 1:
        out.append(("half_lanes", HalfLanes))
    return [(cell, name, f) for name, f in out]


def _short(cell):
    """The cell's traffic with fewer outer iterations and MINRES passes:
    a broken apply keeps the solves from converging, and these keep the
    test to seconds."""
    traffic = spec.traffic(spec.cell(spec.benchmark(), cell)["traffic"])
    short = {"params": dict(traffic["params"], maxit=2)}
    if "linear" in traffic:
        short["linear"] = dict(traffic["linear"], linearIter=500)
    return short


def _run(cell, cpu, fault=None):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return core.run(cell, SEED, 0.0, False, 0.0, device=cpu,
                        sizes=small_sizes(config_of(cell)),
                        traffic=_short(cell), fault=fault)[0]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_of_the_short_traffic_is_correct(cell, cpu):
    """The fault tests' traffic is no fault of its own."""
    result = _run(cell, cpu)
    assert result["correct"] is True and result["failed"] == 0


@pytest.mark.parametrize("cell,name,fault",
                         [x for c in CELLS for x in _faults(c)],
                         ids=lambda x: x if isinstance(x, str) else "")
def test_broken_timed_path_is_not_correct(cell, name, fault, cpu):
    """A whole run, the look for a card skipped, with the fault
    underneath: ``correct`` comes out false, and on a number that judges
    an eigenpair, not on convergence alone."""
    result = _run(cell, cpu, fault())
    assert result["correct"] is False
    assert result["failed"] > 0
    numbers = {k: (c["value"], c["limit"])
               for k, c in result["checks"].items()}
    assert _over(numbers), numbers
