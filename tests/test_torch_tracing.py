"""The port's spans and counters (``eigensolvers_tpu_torch/utils/
profiling.py``), on the CPU: how the spans nest under a profiler, what the
counters count, that nothing is traced without a profiler and that
tracing leaves the arithmetic as it is."""

import json

import numpy as np
import pytest
import torch

from eigensolvers_tpu_torch import (TorchVector,
                                    chebyshevFilteredDiagonalization,
                                    feastDiagonalization,
                                    inexactLanczosDiagonalization)
from eigensolvers_tpu_torch.ops import linear_solvers as ls
from eigensolvers_tpu_torch.ops.operators import (CallableOperator,
                                                  DenseOperator,
                                                  PaddedOperator)
from eigensolvers_tpu_torch.utils import profiling

CPU = torch.device("cpu")
N = 60
LEVELS = np.linspace(1.0, 8.0, N)

# innermost first: each span's nearest enclosing es.* span on the Lanczos
# solve path
CHAIN = ["es.apply", "es.minres.pass", "es.linear.solve", "es.lanczos.solve",
         "es.lanczos.step", "es.lanczos.outer"]


def _matrix(seed=3):
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(N, N)))
    return (q * LEVELS) @ q.T


def _block_lanczos(profiled):
    """A block of three, batched Jacobi MINRES solves, below the spectrum:
    (ev, vectors, status, report, the counters' gain, the profile)."""
    H = DenseOperator(_matrix(), device=CPU)
    g, _ = np.linalg.qr(np.random.default_rng(5).normal(size=(N, 3)))
    report = {}
    opts = {"linearSystemArgs": {"linearSolver": "minres",
                                 "linear_tol": 1e-4, "linear_atol": 1e-8,
                                 "linearIter": 500, "preconditioner": "jacobi",
                                 "report": report}}
    vs = [TorchVector(g[:, i], opts, device=CPU) for i in range(3)]
    before = profiling.snapshot()
    prof = None
    if profiled:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
        prof.__enter__()
    try:
        ev, Y, st = inexactLanczosDiagonalization(H, vs, 0.5, 6, 4, 1e-9,
                                                  writeOut=False)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    return ev, Y, st, report, profiling.delta(before), prof


@pytest.fixture(scope="module")
def runs():
    """The same block solve with a profiler, and without one while
    ``record_function`` raises."""
    out = {"traced": _block_lanczos(True)}

    def refuse(*a, **k):
        raise AssertionError("record_function entered without a profiler")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", refuse)
        mp.setattr(torch.autograd.profiler, "record_function", refuse)
        out["plain"] = _block_lanczos(False)
    return out


def _es_parent(e):
    p = e.cpu_parent
    while p is not None and not p.name.startswith("es."):
        p = p.cpu_parent
    return p


def test_spans_nest_under_the_profiler(runs):
    """Every span of the chain sits in the next one; the outer iteration
    in none; each MINRES pass holds one apply and one read."""
    prof = runs["traced"][5]
    es = [e for e in prof.events() if e.name.startswith("es.")]
    names = {e.name for e in es}
    assert set(CHAIN) <= names and "es.read" in names
    parents = {}
    for e in es:
        p = _es_parent(e)
        parents.setdefault(e.name, set()).add(None if p is None else p.name)
    for child, parent in zip(CHAIN[1:], CHAIN[2:]):
        assert parents[child] == {parent}, (child, parents[child])
    assert parents["es.lanczos.outer"] == {None}
    assert "es.minres.pass" in parents["es.apply"]
    per_pass = {}
    for e in es:
        p = _es_parent(e)
        if p is not None and p.name == "es.minres.pass":
            per_pass.setdefault(id(p), []).append(e.name)
    assert per_pass and all(sorted(v) == ["es.apply", "es.read"]
                            for v in per_pass.values())


@pytest.mark.parametrize("kind", ["traced", "plain"])
def test_counts_match_the_reports(runs, kind):
    """``es.minres.pass`` counts the report's lane applies, and each
    phase's span the timer's calls."""
    _, _, st, report, got, _ = runs[kind]
    assert got["es.minres.pass"]["calls"] == report["matmats"]
    assert got["es.linear.solve"]["calls"] == st["timers"]["solve"]["calls"]
    assert "extend_subspace" in st["timers"]
    for phase, t in st["timers"].items():
        assert got[f"es.lanczos.{phase}"]["calls"] == t["calls"], phase
    assert got["es.lanczos.outer"]["calls"] == st["outerIter"] + 1


def test_no_profiler_same_counts_and_eigenpairs(runs):
    """Without a profiler nothing is traced (``record_function`` raised
    had it been entered), the counts are the profiled run's, and the
    eigenpairs are bitwise the same."""
    ev_t, Y_t, _, rep_t, got_t, _ = runs["traced"]
    ev_p, Y_p, _, rep_p, got_p, _ = runs["plain"]
    assert {k: v["calls"] for k, v in got_t.items()} == \
        {k: v["calls"] for k, v in got_p.items()}
    assert rep_t == rep_p
    np.testing.assert_array_equal(ev_t, ev_p)
    for a, b in zip(Y_t, Y_p):
        assert torch.equal(a.array, b.array)


def test_chrome_trace_holds_the_spans(tmp_path):
    H = DenseOperator(_matrix(), device=CPU)
    v = TorchVector(np.ones(N) / np.sqrt(N), device=CPU)
    with profiling.trace(str(tmp_path)):
        inexactLanczosDiagonalization(H, v, 0.5, 6, 4, 1e-6, writeOut=False)
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"es.lanczos.outer", "es.lanczos.step", "es.lanczos.solve",
            "es.linear.solve", "es.minres.pass", "es.apply",
            "es.read"} <= names


@pytest.mark.parametrize("precond", [None, "jacobi"])
def test_minres_batch_reads_once_a_pass(precond):
    """k passes of the lane MINRES make k + 1 host reads: one a pass and
    the one that starts it (the module docstring's contract)."""
    H = DenseOperator(_matrix(), device=CPU)
    B = torch.as_tensor(np.random.default_rng(1).normal(size=(3, N)))
    before = profiling.snapshot()
    res = ls.minres_batch(H, B, [0.5, 0.6, 0.7], rtol=1e-6, maxiter=400,
                          precond=precond)
    got = profiling.delta(before)
    assert res.matvecs > 10 and bool(np.all(res.converged))
    assert got["es.minres.pass"]["calls"] == res.matvecs
    assert got["es.apply"]["calls"] == res.matvecs
    assert got["es.read"]["calls"] == res.matvecs + 1


@pytest.mark.parametrize("case", ["rowwise", "composite"])
def test_apply_counts_the_outermost_call(case):
    """A lane stack through the row-by-row default is one apply, counted
    as such; a composite's inner apply is not counted again."""
    M = torch.as_tensor(_matrix())
    X = torch.as_tensor(np.random.default_rng(2).normal(size=(3, N)))
    before = profiling.snapshot()
    if case == "rowwise":
        op = CallableOperator(lambda x: M @ x, (N, N))
        Y = op.matvec_lanes(X)
        want = {"es.apply": 1, "es.apply.rowwise": 1,
                "es.apply.m3.float64": 1}
    else:
        op = PaddedOperator(DenseOperator(M, device=CPU), N + 4)
        Y = op.matvec_lanes(torch.nn.functional.pad(X, (0, 4)))[:, :N]
        op.matvec(torch.zeros(N + 4, dtype=torch.float64))
        want = {"es.apply": 2, "es.apply.m3.float64": 1,
                "es.apply.m1.float64": 1}
    got = profiling.delta(before)
    assert {k: v["calls"] for k, v in got.items()} == want
    torch.testing.assert_close(Y, X @ M.T, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("driver, fused", [("feast", True), ("feast", False),
                                           ("chebyshev", True),
                                           ("chebyshev", False)])
def test_outer_iterations_counted(driver, fused, tmp_path):
    """``es.<driver>.outer`` counts the driver's outer iterations, in the
    fused loop and in the host loop."""
    H = DenseOperator(_matrix(), device=CPU)
    g, _ = np.linalg.qr(np.random.default_rng(7).normal(size=(N, 8)))
    opts = {"linearSystemArgs": {"linearSolver": "minres",
                                 "linear_tol": 1e-10, "linearIter": 2000}}
    Y = [TorchVector(g[:, i], opts, device=CPU) for i in range(8)]
    eMin, eMax = LEVELS[2] - 0.05, LEVELS[5] + 0.05
    before = profiling.snapshot()
    if driver == "feast":
        _, _, st = feastDiagonalization(H, Y, 8, "legendre", eMin, eMax,
                                        1e-8, 20, writeOut=False,
                                        batchQuadratureSolves=fused)
    else:
        files = {} if fused else {
            "outFileName": str(tmp_path / "it.out"),
            "summaryFileName": str(tmp_path / "sum.out")}
        _, _, st = chebyshevFilteredDiagonalization(
            H, Y, 120, eMin, eMax, 1e-8, 30,
            specBounds=(LEVELS[0] - 0.1, LEVELS[-1] + 0.1),
            writeOut=not fused, **files)
    got = profiling.delta(before)
    assert st["isConverged"]
    assert got[f"es.{driver}.outer"]["calls"] == st["outerIter"] + 1
