"""The port's FEAST (``feastDiagonalization``: the fused, batched and
sequential loops), its split-complex contour solves
(``gmres_splitc_batch``, ``TorchVector.solveBatchSplit``, the split single
solve) and its quadrature against the JAX package on the same inputs.

The problem is tests/test_feast.py's: n = 100, eigenvalues linspace(1,
200), window [160, 166] (three levels), nc = 8 Legendre (four nodes on
the half contour), m0 = 6.

Tolerances (f64 unless stated):
* in-window eigenvalues of each loop against the JAX package's same loop:
  1e-7 relative (1e-9 inner solves; the loops' trajectories differ only by
  roundoff), and against the exact levels 1e-4 (completeness);
* the split path against ``splitComplex=False`` (complex GMRES): 1e-6;
* FEAST at "high" on f32 blocks (bf16x3 lane stacks in the port, plain
  f32 in the JAX package on the CPU): in-window levels 2e-4 relative
  against each other and the exact ones (the "high" gate of
  ``chip_smoke.py``; they read ~2e-9);
* ``gmres_splitc_batch`` lane by lane against the JAX package's: x to
  1e-10 relative, iterations, convergence flags equal, on a
  well-conditioned problem (~60-140 MINRES iterations per lane, where
  roundoff does not yet move the trajectories), with the escalation
  rounds, the warm-start guard and the rtol floor;
* quadrature nodes, contour and per-node solves against Polizzi's Fortran
  output (tests/data/data_fortranCode.out): 1e-5, as
  tests/test_feast_fortran.py."""

import math
import os

import numpy as np
import pytest
import scipy.linalg as la
import torch

import jax.numpy as jnp
from eigensolvers_tpu import JaxVector
from eigensolvers_tpu import as_operator as jax_as_operator
from eigensolvers_tpu import feastDiagonalization as jax_feast
from eigensolvers_tpu.models.synthetic import known_spectrum_matrix
from eigensolvers_tpu.ops import linear_solvers as jls
from eigensolvers_tpu.ops import sparse as jax_sparse

import eigensolvers_tpu_torch.solvers.feast as feast_mod
from eigensolvers_tpu_torch import (BSROperator, TorchVector,
                                    feastDiagonalization,
                                    quadraturePointsWeights,
                                    select_within_range)
from eigensolvers_tpu_torch.ops import linear_solvers as tls
from eigensolvers_tpu_torch.ops import sparse as bsr
from eigensolvers_tpu_torch.ops.operators import DenseOperator
from eigensolvers_tpu_torch.solvers import fast_feast
from test_torch_common import CPU, as_np, torch_vec

RMIN, RMAX, NC, M0 = 160.0, 166.0, 8, 6
LS = {"linearSolver": "minres", "linearIter": 4000, "linear_tol": 1e-9,
      "linear_atol": 1e-12, "errorOnNonConvergence": False}


@pytest.fixture(scope="module")
def problem():
    n = 100
    ev = np.linspace(1, 200, n)
    rng = np.random.RandomState(10)
    Q = la.qr(rng.rand(n, n))[0]
    A = Q.T @ np.diag(ev) @ Q
    Y0 = np.empty((n, M0))
    for i in range(M0):
        Y0[:, i] = np.ones(n) * (i + 1)
    Y1 = la.qr(Y0, mode="economic")[0]
    inside = select_within_range(ev, RMIN, RMAX)[0]
    return dict(A=A, Y1=Y1, inside=inside)


def _guesses(p, ls=LS, dtype=np.float64):
    opts = {"linearSystemArgs": dict(ls)}
    jv = [JaxVector(p["Y1"][:, i].astype(dtype), opts) for i in range(M0)]
    return jv, [torch_vec(v, opts) for v in jv]


def _in_window(ev):
    return np.sort(select_within_range(np.asarray(ev), RMIN, RMAX)[0])


# loop -> (extra linearSystemArgs, batchQuadratureSolves, maxit).  The
# sequential loop runs its 24 single solves one after another (~2 s per
# outer iteration on the CPU), so it is held to the JAX package over two
# outer iterations; the batched loops run to completeness.
LOOPS = {"fused": (dict(), True, 12),
         "batched": (dict(batchChunk=4 * M0), True, 12),   # one chunk
         "sequential": (dict(), False, 2)}


@pytest.mark.parametrize("loop", list(LOOPS))
def test_feast_loops_match_jax(problem, loop):
    p = problem
    extra, batch, maxit = LOOPS[loop]
    jv, tv = _guesses(p, dict(LS, **extra))
    kw = dict(eConv=1e-10, maxit=maxit, writeOut=False,
              batchQuadratureSolves=batch)
    evj, _, stj = jax_feast(p["A"], jv, NC, "legendre", RMIN, RMAX, **kw)
    evt, uvt, stt = feastDiagonalization(
        DenseOperator(p["A"], device=CPU), tv, NC, "legendre", RMIN, RMAX,
        **kw)
    assert isinstance(evt, np.ndarray) and isinstance(uvt[0], TorchVector)
    assert uvt[0].dtype == torch.float64
    assert set(stt) == set(stj)
    assert stt["outerIter"] == stj["outerIter"]
    gt, gj = _in_window(evt), _in_window(evj)
    assert len(gt) == len(gj) >= len(p["inside"])
    np.testing.assert_allclose(gt, gj, rtol=1e-7)
    if maxit > 2:
        for t in p["inside"]:
            assert np.min(np.abs(gt - t)) <= 1e-4
    S = TorchVector.overlapMatrix(uvt)
    np.testing.assert_allclose(S, np.eye(len(uvt)), atol=1e-8)


def test_fused_loop_applies_the_whole_stack_once_per_pass(problem,
                                                          monkeypatch):
    """On a block-sparse H every MINRES pass of the fused loop is ONE
    apply of all 2 nk m0 real lanes (B3 on the card), the subspace
    assembly one apply of m0 f64 lanes per outer iteration; the report
    counts the stack applies."""
    p = problem
    op = BSROperator.from_dense(p["A"], block_size=32, device=CPU)
    lanes = []
    orig = bsr.bsr_matmat
    monkeypatch.setattr(bsr, "bsr_matmat",
                        lambda d, i, X: lanes.append(X.shape[0]) or orig(d, i, X))
    monkeypatch.setattr(bsr, "bsr_matvec", lambda *a: pytest.fail("SpMV"))
    report = {}
    _, tv = _guesses(p, dict(LS, report=report))
    ev, _, st = feastDiagonalization(op, tv, NC, "legendre", RMIN, RMAX,
                                     1e-10, 12, writeOut=False)
    nk = NC // 2
    outer = st["outerIter"] + 1
    assert lanes.count(M0) == outer
    assert lanes.count(2 * nk * M0) == report["matmats"] == len(lanes) - outer
    assert report["solves"] == outer * nk * M0
    assert st["solverIterations"] == report["iterations"]
    for t in problem["inside"]:
        assert np.min(np.abs(np.asarray(ev) - t)) <= 1e-4


def test_fused_loop_at_high_applies_the_split_stack_once_per_pass(
        problem, monkeypatch):
    """FEAST at "high" on an f32 block-sparse H (the problem's A, blocks of
    32) with f32 guesses, beside the JAX package's
    ``BSROperator(..., precision="high", use_pallas=False)`` on the same
    numbers: every MINRES pass of the fused loop is ONE bf16x3 apply of all
    2 nk m0 lanes (``bsr_matmat_split``, the split kernel on the card), and
    each outer iteration one f64 apply of the m0 carried vectors on the f32
    blocks.  Both find the same in-window levels, within 2e-4 relative of
    each other and of the exact ones (the "high" gate of ``chip_smoke.py``).
    JAX's "high" on the CPU is plain f32 and the port's plain split path is
    bf16x3, so they are not expected to agree bit for bit; measured (9
    outer iterations, f32 solves capped at 60 MINRES iterations): the port
    1.8e-9 and the JAX package 1.8e-9 from the exact levels, 1.7e-9 from
    each other."""
    p = problem
    A32 = p["A"].astype(np.float32)
    op = BSROperator.from_dense(A32, block_size=32, precision="high",
                                device=CPU)
    lanes = []
    split, b3 = bsr.bsr_matmat_split, bsr.bsr_matmat
    monkeypatch.setattr(bsr, "bsr_matmat_split", lambda h, l_, i, X: (
        lanes.append(("split", X.shape[0], X.dtype)) or split(h, l_, i, X)))
    monkeypatch.setattr(bsr, "bsr_matmat", lambda d, i, X: (
        lanes.append(("b3", X.shape[0], X.dtype)) or b3(d, i, X)))
    monkeypatch.setattr(bsr, "bsr_matvec", lambda *a: pytest.fail("SpMV"))
    report = {}
    ls = dict(LS, linearIter=60, linear_tol=1e-5, linear_atol=1e-6,
              report=report)
    jv, tv = _guesses(p, ls, np.float32)
    kw = dict(eConv=1e-8, maxit=12, writeOut=False)
    evt, uvt, st = feastDiagonalization(op, tv, NC, "legendre", RMIN, RMAX,
                                        **kw)
    assert uvt[0].dtype == torch.float64          # the f64 carry
    nk = NC // 2
    outer = st["outerIter"] + 1
    assert lanes.count(("split", 2 * nk * M0, torch.float32)) \
        == report["matmats"] == len(lanes) - outer
    assert lanes.count(("b3", M0, torch.float64)) == outer
    jop = jax_sparse.BSROperator.from_dense(A32, block_size=32,
                                            precision="high",
                                            use_pallas=False)
    evj, _, _ = jax_feast(jop, jv, NC, "legendre", RMIN, RMAX, **kw)
    gt, gj = _in_window(evt), _in_window(evj)
    assert len(gt) == len(gj) == len(p["inside"])
    np.testing.assert_allclose(gt, gj, rtol=2e-4)
    np.testing.assert_allclose(gt, p["inside"], rtol=2e-4)
    np.testing.assert_allclose(gj, p["inside"], rtol=2e-4)


def test_split_path_matches_complex_gmres(problem):
    """The split-complex (J-symmetrized MINRES) contour solves and complex
    GMRES (``splitComplex=False``, restart > n so GMRES is effectively
    full; its lanes run one after another) filter the same subspace: the
    in-window Ritz values of three outer iterations agree to 1e-6 (1e-8
    solves)."""
    p = problem
    A = DenseOperator(p["A"], device=CPU)
    base = dict(LS, linear_tol=1e-8)
    _, tc = _guesses(p, dict(base, linearSolver="gmres", splitComplex=False,
                             gmresRestart=128, linearIter=4000))
    evc, _, _ = feastDiagonalization(A, tc, NC, "legendre", RMIN, RMAX,
                                     1e-10, 3, writeOut=False)
    _, ts = _guesses(p, dict(base, splitComplex=True))
    evs, _, _ = feastDiagonalization(A, ts, NC, "legendre", RMIN, RMAX,
                                     1e-10, 3, writeOut=False)
    gc, gs = _in_window(evc), _in_window(evs)
    assert len(gc) == len(gs) >= len(p["inside"])
    np.testing.assert_allclose(gs, gc, rtol=0, atol=1e-6)


def test_ritz_warm_start_cuts_solver_iterations(problem):
    """x0 = y/(z - ev) is near-exact once y is close to an eigenvector:
    the split MINRES converges in substantially fewer iterations than from
    a zero guess, and both solve the complex system."""
    p = problem
    evs, U = np.linalg.eigh(p["A"])
    lam, v = float(evs[80]), U[:, 80]
    y = v + np.random.RandomState(4).rand(len(v)) * 1e-8
    y /= np.linalg.norm(y)
    z = complex(lam + 1.0, 2.0)
    op = DenseOperator(p["A"], device=CPU)
    Y = torch.as_tensor(y[None, :])
    cold = tls.gmres_splitc_batch(op, Y, [z], rtol=1e-8, maxiter=2000)
    c = 1.0 / (z - lam)
    x0 = torch.as_tensor(np.stack([y * c.real, y * c.imag])[None])
    warm = tls.gmres_splitc_batch(op, Y, [z], x0s=x0, rtol=1e-8,
                                  maxiter=2000)
    assert cold.converged[0] and warm.converged[0]
    assert warm.iterations[0] < 0.8 * cold.iterations[0]
    for res in (cold, warm):
        x = as_np(res.x)[0]
        xc = x[0] + 1j * x[1]
        assert np.linalg.norm(z * xc - p["A"] @ xc - y) < 1e-6


@pytest.fixture(scope="module")
def f32_flags(problem):
    """The warm flag of every fused iteration of an f32 and an f64 run under
    the auto policy, and both runs' status keys beside the JAX package's."""
    p = problem
    ls = dict(LS, linearIter=800, linear_tol=1e-4, linear_atol=1e-4)
    out = {}
    orig = fast_feast.feast_filter_program
    for dtype in (np.float32, np.float64):
        flags = []

        def spy(*args, **kw):
            flags.append(bool(kw.get("warm")))
            return orig(*args, **kw)

        fast_feast.feast_filter_program = spy
        try:
            jv, tv = _guesses(p, ls, dtype)
            _, _, st = feastDiagonalization(
                DenseOperator(p["A"].astype(dtype), device=CPU), tv, NC,
                "legendre", RMIN, RMAX, 1e-14, 7, writeOut=False)
        finally:
            fast_feast.feast_filter_program = orig
        out[dtype] = flags, set(st)
    _, _, stj = jax_feast(jax_as_operator(p["A"].astype(np.float32)),
                          _guesses(p, ls, np.float32)[0], NC, "legendre",
                          RMIN, RMAX, 1e-14, 2, writeOut=False)
    out["jax_keys"] = set(stj)
    return out


def test_f32_auto_policy_is_warm_with_cold_refresh(f32_flags):
    ce = feast_mod.COLD_REFRESH_EVERY
    flags, keys = f32_flags[np.float32]
    assert len(flags) == 7
    assert flags == [bool(i > 0 and i % ce != 0) for i in range(7)]
    assert keys == f32_flags["jax_keys"]


def test_f64_auto_policy_is_always_warm(f32_flags):
    flags, keys = f32_flags[np.float64]
    assert flags == [False] + [True] * (len(flags) - 1)
    assert keys == f32_flags["jax_keys"]


def _split_problem():
    """A well-conditioned complex-shifted set: spectrum in [1, 10], shifts
    with |Im z| >= 1, random real right-hand sides."""
    n = 120
    A, _ = known_spectrum_matrix(n, eigenvalues=np.linspace(1, 10, n), seed=3)
    A = np.asarray(A)
    rng = np.random.RandomState(1)
    sig = np.array([5 + 2j, 3 + 1.5j, 8 + 3j, 5.5 + 1j, 2 + 2.5j, 9 + 1.2j])
    B = rng.rand(len(sig), n)
    xs = np.stack([np.linalg.solve(z * np.eye(n) - A, b)
                   for z, b in zip(sig, B)])
    near = np.stack([xs.real, xs.imag], 1) * (1 + 1e-4 * rng.rand(6, 2, n))
    seeds = near.copy()
    seeds[::2] = 50 * rng.rand(3, 2, n)     # worse than none: the guard
    return A, sig, B, seeds


SPLIT_CASES = {
    "cold": (dict(rtol=1e-10, maxiter=500), False),
    "guard": (dict(rtol=1e-10, maxiter=500), True),
    "escalation": (dict(rtol=1e-10, maxiter=40, escalate=3), False),
    "no-escalation": (dict(rtol=1e-10, maxiter=40, escalate=0), True),
    "rtol-floor": (dict(rtol=1e-30, maxiter=500), True),
    "jacobi": (dict(rtol=1e-10, maxiter=500, precond="jacobi"), True),
    "reverseGF": (dict(rtol=1e-10, maxiter=500, reverseGF=True), True),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_gmres_splitc_batch_matches_jax_lane_by_lane(case):
    kw, seeded = SPLIT_CASES[case]
    A, sig, B, seeds = _split_problem()
    x0 = None
    if seeded:
        x0 = -seeds if kw.get("reverseGF") else seeds
    rj = jls.gmres_splitc_batch(jax_as_operator(A), B, sig, x0s=x0, **kw)
    rt = tls.gmres_splitc_batch(DenseOperator(A, device=CPU),
                                torch.as_tensor(B), sig,
                                x0s=None if x0 is None else
                                torch.as_tensor(x0), **kw)
    xj, xt = np.asarray(rj.x), as_np(rt.x)
    assert xt.shape == xj.shape == (6, 2, B.shape[1])
    for k in range(6):
        np.testing.assert_allclose(xt[k], xj[k], rtol=0,
                                   atol=1e-10 * np.abs(xj[k]).max())
    np.testing.assert_array_equal(rt.iterations, np.asarray(rj.iterations))
    np.testing.assert_array_equal(rt.converged, np.asarray(rj.converged))
    if case == "escalation":       # the boost is what converges them
        assert rt.converged.all() and rt.iterations.max() > 40
    if case == "no-escalation":
        assert not rt.converged.any()
    if case == "rtol-floor":       # clamped at 25 eps: converges
        assert rt.converged.all()


def test_solve_batch_split_matches_jax_and_chunks(problem):
    """TorchVector.solveBatchSplit against JaxVector's: the same (2, n)
    solutions, lane chunks giving the lanes' own results, the report, and
    the per-lane raise or warn."""
    p = problem
    _, _, _, zs = feast_mod._contour(RMIN, RMAX, NC, "legendre", 1.0)
    ls = dict(LS, linear_tol=1e-10)
    jv, tv = _guesses(p, ls)
    sig = [complex(z) for z in zs for _ in range(2)]
    bs_j, bs_t = [jv[i] for _ in zs for i in range(2)], \
        [tv[i] for _ in zs for i in range(2)]
    jx = JaxVector.solveBatchSplit(p["A"], bs_j, sig)
    report = {}
    tx = TorchVector.solveBatchSplit(p["A"], bs_t, sig, report=report)
    assert report["iterations"] > 0
    for a, b in zip(tx, jx):
        np.testing.assert_allclose(as_np(a), np.asarray(b), rtol=0,
                                   atol=1e-8 * np.abs(np.asarray(b)).max())
    _, tc = _guesses(p, dict(ls, batchChunk=3))
    tcx = TorchVector.solveBatchSplit(p["A"], [tc[i] for _ in zs
                                               for i in range(2)], sig)
    for a, b in zip(tcx, tx):
        np.testing.assert_allclose(as_np(a), as_np(b), rtol=0, atol=1e-9)
    _, tbad = _guesses(p, dict(ls, linearIter=3, escalateIter=0,
                               errorOnNonConvergence=True))
    with pytest.raises(RuntimeError, match="lane 0 did not converge"):
        TorchVector.solveBatchSplit(p["A"], tbad[:1], sig[:1])
    tbad[0].options["linearSystemArgs"]["errorOnNonConvergence"] = False
    with pytest.warns(UserWarning, match="did not converge"):
        TorchVector.solveBatchSplit(p["A"], tbad[:1], sig[:1])


def test_quadrature_accumulations_match_jax_in_f64():
    rng = np.random.RandomState(2)
    nk, m0, n = 4, 3, 50
    mults = rng.standard_normal(nk) + 1j * rng.standard_normal(nk)
    S = rng.standard_normal((nk * m0, 2, n)).astype(np.float32)
    jq = JaxVector._accumulate_quadrature_split(list(jnp.asarray(S)), mults,
                                                m0)
    tq = TorchVector._accumulate_quadrature_split(list(torch.as_tensor(S)),
                                                  mults, m0)
    Sc = (S[:, 0] + 1j * S[:, 1]).astype(np.complex64)
    jc = JaxVector._accumulate_quadrature([JaxVector(s) for s in Sc], mults,
                                          m0)
    tc = TorchVector._accumulate_quadrature(
        [TorchVector(s, device=CPU) for s in Sc], mults, m0)
    for a, b in list(zip(tq, jq)) + list(zip(tc, jc)):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(as_np(a.array), np.asarray(b.array),
                                   rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# Polizzi's Fortran FEAST output (tests/test_feast_fortran.py's oracle)
# ---------------------------------------------------------------------------
FORTRAN = os.path.join(os.path.dirname(__file__), "data",
                       "data_fortranCode.out")
F_RMIN, F_RMAX, EFACTOR = 3.0, 5.0, 0.3
ORDER = [4, 3, 5, 2, 6, 1, 7, 0]      # the Fortran code's node order


def _fortran(k=0):
    rd = lambda skip, rows, dt=float: np.loadtxt(   # noqa: E731
        FORTRAN, dtype=dt, skiprows=skip, max_rows=rows)
    return dict(A=rd(1, 4), guess=rd(6, 3, complex), xe=rd(12, 8),
                we=rd(22, 8), theta=rd(32, 8), zne=rd(42, 8, complex),
                Qe=rd(62 + k * 5, 3, complex), Q=rd(102 + k * 5, 3))


def test_quadrature_and_contour_match_fortran():
    f = _fortran()
    gk, wk = quadraturePointsWeights(8, "legendre", positiveHalf=False)
    thetas = -(np.pi * 0.5) * (gk - 1.0)
    r = (F_RMAX - F_RMIN) * 0.5
    zs = (F_RMIN + F_RMAX) * 0.5 + r * (np.cos(thetas)
                                        + EFACTOR * 1j * np.sin(thetas))
    for got, want in ((gk, f["xe"]), (wk, f["we"]), (thetas, f["theta"]),
                      (zs, f["zne"])):
        np.testing.assert_allclose(want, got[ORDER], rtol=1e-5, atol=0)
    # the half contour FEAST uses: the positive nodes, same formula
    gh, wh, th, zh = feast_mod._contour(F_RMIN, F_RMAX, 8, "legendre",
                                        EFACTOR)
    np.testing.assert_array_equal(gh, gk[gk > 0])
    np.testing.assert_allclose(zh, zs[gk > 0], rtol=1e-15)


def test_per_node_solves_and_accumulation_match_fortran():
    f = _fortran()
    opts = {"linearSystemArgs": {"linearSolver": "exact"}}
    Y = [TorchVector(f["guess"][i], opts, device=CPU) for i in range(3)]
    A = DenseOperator(f["A"], device=CPU)
    gk, wk = quadraturePointsWeights(8, "legendre", positiveHalf=False)
    thetas = (-(np.pi * 0.5) * (gk - 1.0))[ORDER]
    wk = wk[ORDER]
    r = (F_RMAX - F_RMIN) * 0.5
    Q = [np.nan] * 3
    for k in range(8):
        fk = _fortran(k)
        z = (F_RMIN + F_RMAX) * 0.5 + r * math.cos(thetas[k]) \
            + r * EFACTOR * 1j * math.sin(thetas[k])
        Qe = np.stack([as_np(TorchVector.solve(A, y, z).array) for y in Y])
        np.testing.assert_allclose(Qe, fk["Qe"], rtol=1e-5, atol=0)
        for i in range(3):
            term = feast_mod.calculateQuadrature(A, Y[i], z, r, thetas[k],
                                                 wk[k], EFACTOR)
            Q = feast_mod.updateQ(Q, i, term, k)
        for i in range(3):
            np.testing.assert_allclose(as_np(Q[i].array), fk["Q"][i],
                                       rtol=1e-5, atol=0)
