"""The fused block-Krylov step and the fused Lanczos driver of the port
against the JAX package's, and block Lanczos with batched and sequential
solves through both packages' general driver, on the cases of
tests/test_fast_lanczos.py and tests/test_lanczos_block.py.

Tolerances (f64):
* ``block_krylov_step``: new vectors, ``h_cols`` and ``s_cols`` to 1e-9
  (Jacobi MINRES to 1e-10 on a diagonally dominant system: ~40
  iterations, whose roundoff stays near 1e-11), lindep flags equal;
* the drivers: nearest eigenvalue within 1e-6 of the JAX package's run
  (eConv 1e-7 to 1e-9 on inexact 1e-5 to 1e-7 inner solves) and within the
  JAX test's bound of the exact level; the 3-fold cluster to 1e-5 (1e-6 for
  the general driver, as tests/test_lanczos_block.py).
"""

import numpy as np
import pytest
import scipy.linalg as la
import torch

import jax.numpy as jnp
from eigensolvers_tpu import JaxVector, find_nearest, get_pick_function_maxOvlp
from eigensolvers_tpu import as_operator as jax_as_operator
from eigensolvers_tpu import inexactLanczosDiagonalization as jax_lanczos
from eigensolvers_tpu.solvers.fast_lanczos import \
    fastLanczosDiagonalization as jax_fast
from eigensolvers_tpu.solvers.step import block_krylov_step as jax_step

from eigensolvers_tpu_torch import TorchVector
from eigensolvers_tpu_torch import get_pick_function_maxOvlp as torch_maxovlp
from eigensolvers_tpu_torch import inexactLanczosDiagonalization as lanczos
from eigensolvers_tpu_torch.models.synthetic import known_spectrum_matrix
from eigensolvers_tpu_torch.solvers.fast_lanczos import \
    fastLanczosDiagonalization as fast
from eigensolvers_tpu_torch.solvers.step import block_krylov_step
from eigensolvers_tpu_torch.utils import checkpointing
from test_torch_common import as_np, dd_matrix, torch_op, torch_vec


def _problem(n=100, seed=1212, lam=(1, 200)):
    ev = np.linspace(*lam, n)
    rng = np.random.RandomState(seed)
    Q = la.qr(rng.rand(n, n))[0]
    return Q.T @ np.diag(ev) @ Q, ev, rng


OPTS = {"linearSystemArgs": {"linearSolver": "gmres", "linearIter": 2000,
                             "linear_tol": 1e-5, "linear_atol": 1e-5,
                             "errorOnNonConvergence": False}}


def _both(A, guesses, sigma, L, maxit, eConv, opts=OPTS, **kw):
    """fastLanczosDiagonalization of both packages on the same guesses."""
    jv = [JaxVector(g, opts) for g in guesses]
    tv = [torch_vec(v, opts) for v in jv]
    jkw = {k: v for k, v in kw.items() if k != "tpick"}
    tkw = {k: v for k, v in kw.items() if k not in ("pick", "tpick")}
    if "tpick" in kw:
        tkw["pick"] = kw["tpick"]
    evj, Yj, stj = jax_fast(A, jv, sigma, L, maxit, eConv, **jkw)
    evt, Yt, stt = fast(A, tv, sigma, L, maxit, eConv, **tkw)
    return (np.asarray(evj), Yj, stj), (np.asarray(evt), Yt, stt)


def _nearest(ev, x):
    return find_nearest(np.real(np.asarray(ev)), np.real(x))[1]


# ---------------------------------------------------------------------------
# the fused step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dependent", [False, True])
def test_block_krylov_step_matches_jax(dependent):
    """Same basis buffer, valid-row count and seeds; with ``dependent`` the
    third seed repeats the first, so its solution is the first's and the
    masked Cholesky flags it."""
    n, M, nvec = 120, 12, 4
    A = dd_matrix(n, seed=2)
    jop = jax_as_operator(A)
    top = torch_op(jop)
    rng = np.random.RandomState(7)
    V = np.zeros((M, n))
    V[:nvec] = la.qr(rng.rand(n, nvec), mode="economic")[0].T
    seeds = rng.rand(3, n)
    if dependent:
        seeds[2] = seeds[0]
    kw = dict(maxiter=4000, precond="jacobi")
    jo = jax_step(jop, jnp.asarray(V), jnp.asarray(nvec), jnp.asarray(seeds),
                  40.0, 1e-10, **kw)
    report = {}
    to = block_krylov_step(top, torch.as_tensor(V), nvec,
                           torch.as_tensor(seeds), 40.0, 1e-10, report=report,
                           **kw)
    np.testing.assert_array_equal(to.lindep_flags,
                                  np.asarray(jo.lindep_flags))
    assert bool(to.lindep_flags[2]) == dependent
    assert not to.lindep_flags[:2].any()
    for mine, theirs in ((as_np(to.new_vectors), jo.new_vectors),
                         (to.h_cols, jo.h_cols), (to.s_cols, jo.s_cols)):
        theirs = np.asarray(theirs)
        assert mine.shape == theirs.shape
        np.testing.assert_allclose(mine, theirs, rtol=0, atol=1e-9)
    # residuals at roundoff level: both within the solve contract
    bound = 1e-10 * np.linalg.norm(seeds, axis=1)
    assert np.all(to.solve_resnorms <= bound)
    assert np.all(np.asarray(jo.solve_resnorms) <= bound)
    # three lanes solved as one stack, plus one apply for the H columns
    assert report["solves"] == 3 and report["matmats"] > 1


# ---------------------------------------------------------------------------
# the fused driver, cases of tests/test_fast_lanczos.py
# ---------------------------------------------------------------------------
def test_fast_single_vector_matches_jax():
    A, evE, rng = _problem()
    g = rng.rand(100)
    g /= np.linalg.norm(g)
    (evj, _, stj), (evt, Yt, stt) = _both(A, [g], 30.0, 6, 4, 1e-8)
    want = find_nearest(evE, 30.0)[1]
    assert abs(_nearest(evt, 30.0) - _nearest(evj, 30.0)) < 1e-6
    assert abs(_nearest(evt, 30.0) - want) < 1e-4
    assert stt["isConverged"] and set(stt) == set(stj)
    evals, uv = np.linalg.eigh(A)
    vex = uv[:, np.argmin(np.abs(evals - 30.0))]
    assert isinstance(Yt[0], TorchVector)
    assert abs(abs(vex @ as_np(Yt[0].array)) - 1.0) < 1e-4


def test_fast_block_degenerate_matches_jax():
    n = 100
    ev = np.linspace(1, 200, n)
    ev[5:8] = ev[5]
    rng = np.random.RandomState(4)
    Q = la.qr(rng.rand(n, n))[0]
    A = Q.T @ np.diag(ev) @ Q
    sigma = float(ev[5]) + 1.5
    G = la.qr(rng.rand(n, 3), mode="economic")[0]
    (evj, _, _), (evt, _, _) = _both(A, list(G.T), sigma, 5, 6, 1e-7)
    for e in (evj, evt):
        got = np.sort(e[np.argsort(np.abs(e - sigma))[:3]])
        np.testing.assert_allclose(got, ev[5:8], rtol=1e-5)


def test_fast_restart_path_matches_jax():
    A, evE, rng = _problem(n=300, seed=9, lam=(1, 600))
    g = rng.rand(300)
    g /= np.linalg.norm(g)
    report = {}
    opts = {"linearSystemArgs": dict(OPTS["linearSystemArgs"], report=report)}
    (evj, _, stj), (evt, _, stt) = _both(A, [g], 90.0, 4, 12, 1e-9, opts)
    want = find_nearest(evE, 90.0)[1]
    assert abs(_nearest(evt, 90.0) - want) < 1e-5
    assert abs(_nearest(evt, 90.0) - _nearest(evj, 90.0)) < 1e-6
    assert stt["outerIter"] >= 1
    # guess block, one per step (H columns) and one per restart, plus the
    # solves' applies: all counted as lane-stack applies
    steps = stt["timers"]["fused_step"]["calls"]
    restarts = stt["timers"].get("restart", {"calls": 0})["calls"]
    assert report["solves"] == steps
    assert report["matmats"] > 1 + steps + restarts


def test_fast_preconditioned_matches_jax_and_general():
    A, evE, rng = _problem(n=150, seed=6, lam=(1, 300))
    opts = {"linearSystemArgs": {"linearSolver": "minres", "linearIter": 4000,
                                 "linear_tol": 1e-6,
                                 "preconditioner": "jacobi",
                                 "errorOnNonConvergence": False}}
    g = rng.rand(150)
    g /= np.linalg.norm(g)
    (evj, _, stj), (evt, _, stt) = _both(A, [g], 45.0, 6, 4, 1e-8, opts)
    evG, _, stG = lanczos(A, [TorchVector(g, opts)], 45.0, 6, 4, 1e-8,
                          writeOut=False)
    assert stt["isConverged"] and stG["isConverged"]
    assert abs(_nearest(evt, 45.0) - _nearest(evG, 45.0)) < 1e-7
    assert abs(_nearest(evt, 45.0) - _nearest(evj, 45.0)) < 1e-7
    assert abs(_nearest(evt, 45.0) - find_nearest(evE, 45.0)[1]) < 1e-4


def test_fast_complex_shift_matches_jax():
    """A complex shift routes the fused step's solves to GMRES lanes on a
    complex basis; the Hermitian Ritz values converge near Re(sigma)."""
    A, evE, rng = _problem(n=100, seed=3)
    sigma = 30.0 + 0.75j
    opts = {"linearSystemArgs": {"linearSolver": "gmres", "linearIter": 4000,
                                 "gmresRestart": 60, "linear_tol": 1e-7,
                                 "splitComplex": False,
                                 "errorOnNonConvergence": False}}
    g = rng.rand(100)
    g /= np.linalg.norm(g)
    (evj, _, _), (evt, Yt, stt) = _both(A, [g], sigma, 6, 4, 1e-8, opts)
    want = find_nearest(evE, 30.0)[1]
    assert abs(_nearest(evt, sigma) - want) < 1e-4
    assert abs(_nearest(evt, sigma) - _nearest(evj, sigma)) < 1e-6
    assert stt["isConverged"] and Yt[0].dtype == torch.complex128


def test_fast_reporting_and_checkpoint(tmp_path):
    """Two-file output with sentinels and resumable per-iteration
    checkpoints, in both packages."""
    A, evE, rng = _problem()
    g = rng.rand(100)
    g /= np.linalg.norm(g)
    paths = {}
    for name in ("jax", "torch"):
        d = tmp_path / name
        paths[name] = dict(writeOut=True,
                           outFileName=str(d / "iterations_fast.out"),
                           summaryFileName=str(d / "summary_fast.out"),
                           saveEachIteration=True, saveDir=str(d / "ck"))
        d.mkdir()
    jv = JaxVector(g, OPTS)
    jax_fast(A, [jv], 30.0, 6, 4, 1e-8, **paths["jax"])
    evt, _, stt = fast(A, [torch_vec(jv, OPTS)], 30.0, 6, 4, 1e-8,
                       **paths["torch"])
    for name in ("jax", "torch"):
        p = paths[name]
        stxt = open(p["summaryFileName"]).read()
        assert "startingPoint" in stxt and "endingPoint" in stxt
        itxt = open(p["outFileName"]).read()
        assert "OVERLAP MATRIX" in itxt and "FINAL RESULTS" in itxt
    ck = paths["torch"]["saveDir"]
    tag = checkpointing.latest_tag(ck)
    assert tag == stt["cumIter"]
    vecs, meta = checkpointing.load_checkpoint(ck, tag, TorchVector)
    assert len(vecs) >= 2 and "eigenvalues" in meta
    assert meta["status"]["cumIter"] == tag
    # the JAX package reads the port's checkpoint
    from eigensolvers_tpu.utils import checkpointing as jax_ckpt
    jvecs, _ = jax_ckpt.load_checkpoint(ck, tag, JaxVector)
    np.testing.assert_array_equal(np.asarray(jvecs[-1].array),
                                  as_np(vecs[-1].array))


def test_fast_state_following_maxovlp_matches_jax():
    """maxOvlp pick through the basis-row proxies: follow the
    second-nearest eigenvector past the nearer root."""
    A, evE, rng = _problem(n=120, seed=2, lam=(1, 240))
    evals, uv = np.linalg.eigh(A)
    target = np.argsort(np.abs(evals - 50.0))[1]
    guess = uv[:, target] + 0.05 * rng.rand(120)
    guess /= np.linalg.norm(guess)
    (evj, _, _), (evt, Yt, _) = _both(
        A, [guess], 50.0, 8, 6, 1e-9,
        pick=get_pick_function_maxOvlp(JaxVector(uv[:, target])),
        tpick=torch_maxovlp(TorchVector(uv[:, target])))
    assert abs(evt[0] - evals[target]) < 1e-4 * max(1.0, abs(evals[target]))
    assert abs(evt[0] - evj[0]) < 1e-6
    assert abs(abs(uv[:, target] @ as_np(Yt[0].array)) - 1.0) < 1e-3


@pytest.mark.slow
def test_bench_headline_task_matches_jax():
    """bench.py's headline task: n = 2048 known spectrum, sigma at index
    1316, L = 30, maxit = 10, eConv = 1e-6, MINRES 1e-4 solves; the
    nearest eigenvalue agrees between the packages and lies within bench.py's
    bound (1e-2) of the truth.  Slow: ~40 s on one CPU thread (tens of
    thousands of dense 2048 matvecs in each package); chip_smoke.py runs
    the same task in f32 on the card."""
    from eigensolvers_tpu_torch import calculateTarget
    H, ev = known_spectrum_matrix(2048, eigenvalues=np.linspace(1, 1400, 2048),
                                  seed=10)
    sigma = float(calculateTarget(ev, 1316))
    truth = float(ev[np.argmin(np.abs(ev - sigma))])
    guess = np.random.RandomState(3).rand(2048)
    opts = {"linearSystemArgs": {"linearSolver": "minres", "linearIter": 8000,
                                 "linear_tol": 1e-4, "linear_atol": 1e-4,
                                 "errorOnNonConvergence": False}}
    (evj, _, _), (evt, _, _) = _both(H, [guess], sigma, 30, 10, 1e-6, opts)
    assert abs(_nearest(evt, sigma) - truth) < 1e-2
    assert abs(_nearest(evt, sigma) - _nearest(evj, sigma)) <= \
        1e-6 * abs(truth)


# ---------------------------------------------------------------------------
# block Lanczos, general driver: tests/test_lanczos_block.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("batched", [True, False],
                         ids=["batched", "sequential"])
def test_block_lanczos_degenerate_cluster_matches_jax(batched):
    n, nBlock, iBlock = 100, 3, 5
    ev = np.linspace(1, 200, n)
    ev[iBlock:iBlock + nBlock] = ev[iBlock]
    rng = np.random.RandomState(1212)
    Q = la.qr(rng.rand(n, n))[0]
    A = Q.T @ np.diag(ev) @ Q
    report = {}
    options = {"linearSystemArgs": {
        "linearSolver": "gcrotmk", "linearIter": 1000, "linear_tol": 1e-4}}
    Ys = la.qr(rng.rand(n, nBlock), mode="economic")[0]
    sigma = ev[iBlock] + nBlock / 2
    jY = [JaxVector(Ys[:, i], options) for i in range(nBlock)]
    tY = [torch_vec(v, {"linearSystemArgs": dict(
        options["linearSystemArgs"], report=report)}) for v in jY]
    evJ, _, _ = jax_lanczos(A, jY, sigma, 6, 4, 1e-6, writeOut=False,
                            batchBlockSolves=batched)
    evT, uvT, stT = lanczos(A, tY, sigma, 6, 4, 1e-6, writeOut=False,
                            batchBlockSolves=batched)
    np.testing.assert_allclose(evT[:nBlock], ev[iBlock:iBlock + nBlock],
                               rtol=1e-6)
    np.testing.assert_allclose(evT[:nBlock], np.asarray(evJ)[:nBlock],
                               rtol=1e-6)
    exact = np.linalg.eigh(A)[1][:, iBlock:iBlock + nBlock]
    lv = np.stack([as_np(uvT[i].array) for i in range(nBlock)]).T
    trace = np.abs(la.eigvals(lv.T.conj() @ exact)).sum()
    np.testing.assert_allclose(trace, 3, atol=1e-6)
    # batched: the solves of a step went through lane-stack applies
    assert ("matmats" in report) == batched
    assert report["solves"] == nBlock * stT["timers"]["solve"]["calls"]
