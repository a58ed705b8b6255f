"""The port's batched and general shifted solves against the JAX package on
the same inputs: ``minres_batch``, ``gmres`` / ``gmres_batch``, the exact
solves, ``TorchVector.solveBatch``, and the scipy-style operators that
``as_operator`` wraps.

Tolerances (f64 throughout):
* batched MINRES against JAX ``minres_batch``: the tolerances of
  tests/test_torch_minres.py — x to 1e-9 relative, converged flags equal,
  iterations within 2 or 2 %, whichever is more (roundoff differences in
  the stopping test).  The unpreconditioned interior solves take ~250
  iterations, and there a one-ulp change of b alone moves the port's own
  single-solve x by up to 1.3e-9 (measured on these systems), so those
  lanes are held to 5e-9;
* each lane against the port's own single ``minres`` on that lane alone:
  iterations equal and x to 1e-12 relative.  This is checked on definite
  shifted systems; on indefinite ones a one-ulp change of b already moves
  x by up to 1e-9 and the count by an iteration or two in either solver,
  and the two forms differ in summation order (one multi-vector product
  against one matvec), so there the lanes are held to the JAX bound;
* GMRES against JAX: x to 1e-9 relative and equal iteration counts, and
  against ``numpy.linalg.solve`` to 1e-7 (the 1e-10 solve tolerance times
  the conditioning);
* exact solves: 1e-12 relative against JAX and numpy (both LU)."""

import numpy as np
import pytest
import scipy.linalg as la
import torch
from scipy.sparse.linalg import aslinearoperator

import jax.numpy as jnp
from eigensolvers_tpu import JaxVector
from eigensolvers_tpu import as_operator as jax_as_operator
from eigensolvers_tpu.ops import linear_solvers as jls
from eigensolvers_tpu.ops.operators import (CallableOperator as JaxCallable,
                                            PaddedOperator as JaxPadded)

from eigensolvers_tpu_torch import TorchVector, as_operator
from eigensolvers_tpu_torch.ops import linear_solvers as tls
from eigensolvers_tpu_torch.ops.operators import (CallableOperator,
                                                  DenseOperator,
                                                  PaddedOperator)
from test_torch_common import as_np, dd_matrix, torch_op, torch_vec


def _iter_slack(its):
    return max(2, int(np.ceil(0.02 * its)))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _pair(A):
    jop = jax_as_operator(A)
    return jop, torch_op(jop)


def _lanes(n, seed):
    """Three right-hand sides and warm starts: zero, near the solution of
    lane 1's system, and small noise."""
    rng = np.random.RandomState(seed)
    B = rng.rand(3, n)
    X0 = np.zeros((3, n))
    X0[2] = 1e-3 * rng.standard_normal(n)
    return B, X0


@pytest.mark.parametrize("precond", [None, "jacobi"])
@pytest.mark.parametrize("reverseGF", [False, True])
def test_minres_batch_matches_jax(precond, reverseGF):
    """Different interior shifts per lane and warm starts."""
    n = 200
    A = dd_matrix(n)
    jop, top = _pair(A)
    B, X0 = _lanes(n, 0)
    sig = [40.0, 30.0, 25.0]
    sign = -1.0 if reverseGF else 1.0
    X0[1] = np.linalg.solve(sign * (sig[1] * np.eye(n) - A), B[1]) \
        + 1e-3 * np.random.RandomState(1).rand(n)
    kw = dict(rtol=1e-8, maxiter=4000, precond=precond, reverseGF=reverseGF)
    jr = jls.minres_batch(jop, jnp.asarray(B), jnp.asarray(sig),
                          x0s=jnp.asarray(X0), **kw)
    tr = tls.minres_batch(top, torch.as_tensor(B), sig,
                          x0s=torch.as_tensor(X0), **kw)
    for k in range(3):
        xj = np.asarray(jr.x[k])
        assert _rel(as_np(tr.x[k]), xj) <= (1e-9 if precond else 5e-9)
        assert bool(jr.converged[k]) == bool(tr.converged[k]) is True
        its = int(jr.iterations[k])
        assert abs(its - int(tr.iterations[k])) <= _iter_slack(its)
        x_ref = np.linalg.solve(sign * (sig[k] * np.eye(n) - A), B[k])
        assert _rel(as_np(tr.x[k]), x_ref) <= 1e-6
    # one lane-stack apply per pass: at least the longest lane's iterations
    assert max(tr.iterations) < tr.matvecs <= sum(tr.iterations) + 3 * 10


@pytest.mark.parametrize("precond", [None, "jacobi"])
@pytest.mark.parametrize("reverseGF", [False, True])
def test_minres_batch_lanes_match_single_minres(precond, reverseGF):
    """Lane k of the batch ends where the single solve of lane k ends: the
    same iterations (per-lane sweeps, gates and continuation rounds) and
    x to 1e-12, with lanes that stop at different iterations."""
    n = 200
    A = dd_matrix(n, seed=5)
    top = torch_op(jax_as_operator(A))
    B, X0 = _lanes(n, 2)
    sig = [-5.0, -60.0, 0.5]          # below the spectrum: definite systems
    kw = dict(rtol=1e-10, maxiter=4000, precond=precond, reverseGF=reverseGF)
    tr = tls.minres_batch(top, torch.as_tensor(B), sig,
                          x0s=torch.as_tensor(X0), **kw)
    its = []
    for k in range(3):
        one = tls.minres(top, torch.as_tensor(B[k]), sig[k],
                         x0=torch.as_tensor(X0[k]), **kw)
        assert int(tr.iterations[k]) == one.iterations
        assert bool(tr.converged[k]) == one.converged is True
        assert _rel(as_np(tr.x[k]), as_np(one.x)) <= 1e-12
        its.append(one.iterations)
    assert len(set(its)) > 1


def test_minres_batch_budget_and_frozen_lanes():
    """A budget that stops lanes before convergence: every lane reports
    non-convergence at the budget, like the JAX package; a lane that needs
    no iteration (b = 0) stays exactly zero."""
    n = 120
    A = dd_matrix(n, seed=7)
    jop, top = _pair(A)
    B = np.random.RandomState(3).rand(3, n)
    B[1] = 0.0
    for precond in (None, "jacobi"):
        kw = dict(rtol=1e-12, maxiter=6, precond=precond)
        jr = jls.minres_batch(jop, jnp.asarray(B), jnp.asarray([40.0] * 3),
                              **kw)
        tr = tls.minres_batch(top, torch.as_tensor(B), [40.0] * 3, **kw)
        np.testing.assert_array_equal(np.asarray(jr.iterations),
                                      tr.iterations)
        np.testing.assert_array_equal(np.asarray(jr.converged),
                                      tr.converged)
        assert _rel(as_np(tr.x), np.asarray(jr.x)) <= 1e-9
        assert not np.any(as_np(tr.x[1]))


@pytest.fixture(scope="module")
def hermitian():
    """The complex-Hermitian problem of tests/test_complex.py."""
    n = 80
    ev = np.linspace(1, 160, n)
    rng = np.random.RandomState(7)
    Q = la.qr(rng.rand(n, n) + 1j * rng.rand(n, n))[0]
    A = Q.conj().T @ np.diag(ev) @ Q
    b = rng.rand(3, n) + 1j * rng.rand(3, n)
    return A, b


@pytest.mark.parametrize("precond", [None, "jacobi"])
def test_gmres_complex_shift_matches_jax(hermitian, precond):
    A, b = hermitian
    jop, top = _pair(A)
    sigma = 50.2 + 0.7j
    kw = dict(rtol=1e-10, restart=30, maxiter=3000, precond=precond)
    jr = jls.gmres(jop, jnp.asarray(b[0]), sigma, **kw)
    tr = tls.gmres(top, torch.as_tensor(b[0]), sigma, **kw)
    assert tr.x.dtype == torch.complex128
    assert _rel(as_np(tr.x), np.asarray(jr.x)) <= 1e-9
    assert bool(jr.converged) and tr.converged
    assert int(jr.iterations) == tr.iterations
    x_ref = np.linalg.solve(sigma * np.eye(len(A)) - A, b[0])
    assert _rel(as_np(tr.x), x_ref) <= 1e-7
    assert tr.matvecs > 1


def test_gmres_batch_matches_jax(hermitian):
    """Three lanes with their own complex shifts, reverse Green's function,
    right Jacobi and a short restart."""
    A, b = hermitian
    jop, top = _pair(A)
    sig = np.array([50.2 + 0.7j, 20.0 + 1.5j, 100.0 - 2.0j])
    kw = dict(rtol=1e-10, restart=12, maxiter=3000, precond="jacobi",
              reverseGF=True)
    jr = jls.gmres_batch(jop, jnp.asarray(b), jnp.asarray(sig), **kw)
    tr = tls.gmres_batch(top, torch.as_tensor(b), sig, **kw)
    for k in range(3):
        assert _rel(as_np(tr.x[k]), np.asarray(jr.x[k])) <= 1e-9
        assert int(jr.iterations[k]) == int(tr.iterations[k])
        x_ref = np.linalg.solve(-(sig[k] * np.eye(len(A)) - A), b[k])
        assert _rel(as_np(tr.x[k]), x_ref) <= 1e-7
    assert tr.converged.all()


def test_exact_solves_match_jax_and_numpy():
    """Repeated shifts share one factorisation per distinct shift; a
    complex shift on real data promotes the lane to complex."""
    n = 90
    A = dd_matrix(n, seed=9)
    jop, top = _pair(A)
    B = np.random.RandomState(4).rand(5, n)
    sig = np.array([40.0, 35.0, 40.0, 35.0 + 1.0j, 40.0])
    jouts = jls.solve_exact_batch(jop, jnp.asarray(B), sig, reverseGF=True)
    touts = tls.solve_exact_batch(top, torch.as_tensor(B), sig,
                                  reverseGF=True)
    for k, (j, t) in enumerate(zip(jouts, touts)):
        x_ref = np.linalg.solve(-(sig[k] * np.eye(n) - A), B[k])
        assert _rel(as_np(t.x), np.asarray(j.x)) <= 1e-12
        assert _rel(as_np(t.x), x_ref) <= 1e-12
        assert t.converged and t.iterations == 1
    one = tls.solve_exact(top, torch.as_tensor(B[0]), 40.0)
    assert _rel(as_np(one.x), np.asarray(jls.solve_exact(jop, B[0], 40.0).x)
                ) <= 1e-12


def test_exact_solve_on_padded_operator():
    """sigma = 0 makes sigma*I - H_pad singular on the padding block: both
    packages solve on the logical block and re-pad with zeros."""
    n, n_pad = 60, 64
    A = dd_matrix(n, seed=2)
    jpad = JaxPadded(jax_as_operator(A), n_pad)
    tpad = PaddedOperator(DenseOperator(A), n_pad)
    b = np.zeros((2, n_pad))
    b[:, :n] = np.random.RandomState(5).rand(2, n)
    for j, t in ((jls.solve_exact(jpad, jnp.asarray(b[0]), 0.0),
                  tls.solve_exact(tpad, torch.as_tensor(b[0]), 0.0)),
                 (jls.solve_exact_batch(jpad, jnp.asarray(b), [0.0, 0.0])[1],
                  tls.solve_exact_batch(tpad, torch.as_tensor(b),
                                        [0.0, 0.0])[1])):
        assert t.x.shape == (n_pad,)
        assert _rel(as_np(t.x), np.asarray(j.x)) <= 1e-12
        assert not np.any(as_np(t.x)[n:])
    x = torch.as_tensor(b[0])
    np.testing.assert_allclose(as_np(tpad.matvec(x)),
                               np.asarray(jpad.matvec(b[0])), atol=1e-12)
    np.testing.assert_allclose(as_np(tpad.to_dense()),
                               np.asarray(jpad.to_dense()), atol=0)
    np.testing.assert_allclose(as_np(tpad.diagonal()),
                               np.asarray(jpad.diagonal()), atol=0)


def _batch_vectors(n, m, opts, seed=6):
    bs = np.random.RandomState(seed).rand(m, n)
    jbs = [JaxVector(b, opts) for b in bs]
    return jbs, [torch_vec(v, opts) for v in jbs]


@pytest.mark.parametrize("chunk", [None, 2])
def test_solve_batch_matches_jax_and_reports(chunk):
    """Five lanes, chunked by two or not; the caller's report sums the
    lanes' iterations like the JAX package's, and the shared report counts
    the solves and the lane-stack applies."""
    n = 150
    A = dd_matrix(n, seed=8)
    jop, top = _pair(A)
    lsa = {"linear_tol": 1e-9, "linear_atol": 1e-9, "linearIter": 4000,
           "preconditioner": "jacobi", "batchChunk": chunk}
    shared = {}
    jbs, tbs = _batch_vectors(n, 5, {"linearSystemArgs": lsa})
    tbs = [TorchVector(v.array, {"linearSystemArgs": dict(lsa, report=shared)})
           for v in tbs]
    sig = [40.0, 45.0, 50.0, 55.0, 60.0]
    jrep, trep = {}, {}
    jx = JaxVector.solveBatch(jop, jbs, sig, report=jrep)
    tx = TorchVector.solveBatch(top, tbs, sig, report=trep)
    for j, t in zip(jx, tx):
        assert _rel(as_np(t.array), np.asarray(j.array)) <= 1e-9
    assert abs(trep["iterations"] - jrep["iterations"]) <= \
        _iter_slack(jrep["iterations"])
    assert shared["solves"] == 5 and shared["iterations"] == \
        trep["iterations"]
    assert 0 < shared["matmats"] <= trep["iterations"] + 5 * 10


def test_solve_batch_exact_and_gmres_routes_match_jax(hermitian):
    A, b = hermitian
    jop, top = _pair(A)
    for solver, sig in (("exact", [50.2, 50.2, 20.0]),
                        ("gmres", [50.2 + 0.7j, 20.0 + 1.5j, 80.0 + 2.0j])):
        lsa = {"linearSolver": solver, "linear_tol": 1e-10,
               "linear_atol": 1e-10, "linearIter": 3000}
        opts = {"linearSystemArgs": lsa}
        jbs = [JaxVector(v, opts) for v in b]
        jx = JaxVector.solveBatch(jop, jbs, sig)
        tx = TorchVector.solveBatch(top, [torch_vec(v, opts) for v in jbs],
                                    sig)
        for j, t in zip(jx, tx):
            assert _rel(as_np(t.array), np.asarray(j.array)) <= 1e-9


def test_solve_batch_non_converging_lane_raises_or_warns():
    n = 100
    A = dd_matrix(n)
    jop, top = _pair(A)
    lsa = {"linearIter": 3, "linear_tol": 1e-12, "linear_atol": 1e-12}
    jbs, tbs = _batch_vectors(n, 2, {"linearSystemArgs": lsa})
    with pytest.raises(RuntimeError, match="lane 0 did not converge"):
        JaxVector.solveBatch(jop, jbs, [40.0, 41.0])
    with pytest.raises(RuntimeError, match="lane 0 did not converge"):
        TorchVector.solveBatch(top, tbs, [40.0, 41.0])
    lsa["errorOnNonConvergence"] = False
    _, tbs = _batch_vectors(n, 2, {"linearSystemArgs": lsa})
    with pytest.warns(UserWarning, match="lane 1 did not converge"):
        out = TorchVector.solveBatch(top, tbs, [40.0, 41.0])
    assert len(out) == 2


def test_as_operator_wraps_scipy_linear_operator_like_jax():
    """A scipy LinearOperator becomes a CallableOperator in both packages;
    the port's solves run through it (its matvec takes numpy arrays), and
    the JAX package solves through a jnp callable of the same matrix."""
    n = 60
    A = dd_matrix(n, seed=4)
    Lop = aslinearoperator(A)
    jcall = jax_as_operator(Lop)
    tcall = as_operator(Lop)
    assert isinstance(jcall, JaxCallable) and isinstance(tcall,
                                                         CallableOperator)
    assert tcall.shape == tuple(jcall.shape) == (n, n)
    assert tcall.dtype == torch.float64
    np.testing.assert_allclose(as_np(tcall.to_dense()), A, atol=1e-13)

    class JnpLinearOperator:          # the JAX package's traceable analogue
        shape = (n, n)
        dtype = np.float64

        def matvec(self, x):
            return jnp.asarray(A) @ x

    opts = {"linearSystemArgs": {"linear_tol": 1e-10, "linear_atol": 1e-10,
                                 "linearIter": 4000}}
    b = np.random.RandomState(3).rand(n)
    jx = JaxVector.solve(JnpLinearOperator(), JaxVector(b, opts), 40.0)
    tx = TorchVector.solve(Lop, TorchVector(b, opts), 40.0)
    assert _rel(as_np(tx.array), np.asarray(jx.array)) <= 1e-9
    x_ref = np.linalg.solve(40.0 * np.eye(n) - A, b)
    assert _rel(as_np(tx.array), x_ref) <= 1e-7
