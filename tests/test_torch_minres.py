"""The port's MINRES shifted solver against the JAX package's ``ls.minres``
on the same shifted systems (the cases of tests/test_preconditioner.py),
plain and Jacobi-preconditioned.

Tolerances: both run the same Paige-Saunders recurrence in f64 and differ
only in summation order (and the port keeps its rotation scalars in host
doubles).  Solutions agree to 1e-9 relative on the well-conditioned
diagonally dominant systems at rtol 1e-8; on the banded system with sigma
a fifth of a gap from an eigenvalue, roundoff differences are amplified
by the conditioning, and the bound is the solve tolerance itself (1e-6
relative).  The converged flags are equal.  The iteration counts may
differ by 2 or by 2 %, whichever is more: a roundoff-level change in
phibar moves the stopping test by an iteration, and over hundreds of
iterations the recurrence's loss of orthogonality follows the roundoff."""

import numpy as np
import pytest
import torch

from eigensolvers_tpu import as_operator as jax_as_operator
from eigensolvers_tpu.ops import linear_solvers as jls
from eigensolvers_tpu.ops.sparse import BSROperator as JaxBSR

from eigensolvers_tpu_torch.ops import linear_solvers as tls
from test_torch_common import as_np, banded, dd_matrix, torch_op



def _iter_slack(its):
    return max(2, int(np.ceil(0.02 * its)))


def _pair(A, **kw):
    jop = jax_as_operator(A)
    return jop, torch_op(jop)


def _compare(jr, tr, x_ref=None, xtol=1e-9):
    xj, xt = np.asarray(jr.x), as_np(tr.x)
    np.testing.assert_allclose(xt, xj, rtol=0, atol=xtol * np.abs(xj).max())
    assert bool(jr.converged) == bool(tr.converged)
    its = int(jr.iterations)
    assert abs(its - int(tr.iterations)) <= _iter_slack(its), \
        (its, int(tr.iterations))
    if x_ref is not None:
        np.testing.assert_allclose(xt, x_ref, atol=1e-5)


@pytest.mark.parametrize("precond", [None, "jacobi"])
@pytest.mark.parametrize("reverseGF", [False, True])
def test_minres_matches_jax(precond, reverseGF):
    n = 400
    A = dd_matrix(n)
    jop, top = _pair(A)
    b = np.random.RandomState(0).rand(n)
    sigma = 40.0                  # interior shift -> indefinite system
    jr = jls.minres(jop, b, sigma, rtol=1e-8, maxiter=4000, precond=precond,
                    reverseGF=reverseGF)
    tr = tls.minres(top, torch.as_tensor(b), sigma, rtol=1e-8, maxiter=4000,
                    precond=precond, reverseGF=reverseGF)
    sign = -1.0 if reverseGF else 1.0
    x_ref = np.linalg.solve(sign * (sigma * np.eye(n) - A), b)
    _compare(jr, tr, x_ref)
    assert tr.converged


def test_jacobi_cuts_iterations_like_jax():
    A = dd_matrix(400)
    jop, top = _pair(A)
    b = torch.as_tensor(np.random.RandomState(0).rand(400))
    plain = tls.minres(top, b, 40.0, rtol=1e-8, maxiter=4000)
    prec = tls.minres(top, b, 40.0, rtol=1e-8, maxiter=4000, precond="jacobi")
    assert prec.iterations < plain.iterations
    # unpreconditioned: one initial residual plus one matvec per iteration
    assert plain.matvecs == plain.iterations + 1


@pytest.mark.parametrize("precond", [None, "jacobi"])
def test_warm_start_sweeps_match_jax(precond):
    """A nonzero x0 (the oldb-gated first step of a sweep) and a tiny
    iteration budget that stops before convergence."""
    A = dd_matrix(300, seed=11)
    jop, top = _pair(A)
    rng = np.random.RandomState(1)
    b = rng.rand(300)
    x0 = np.linalg.solve(35.0 * np.eye(300) - A, b) + 1e-3 * rng.rand(300)
    for maxiter in (5, 4000):
        jr = jls.minres(jop, b, 35.0, x0=x0, rtol=1e-10, maxiter=maxiter,
                        precond=precond)
        tr = tls.minres(top, torch.as_tensor(b), 35.0, x0=torch.as_tensor(x0),
                        rtol=1e-10, maxiter=maxiter, precond=precond)
        _compare(jr, tr)


def test_breakdown_stops_at_beta_zero():
    """b an exact eigenvector: the Krylov space is one-dimensional, beta
    becomes 0 and both solvers stop with the exact solution."""
    A = np.diag(np.arange(1.0, 21.0))
    jop, top = _pair(A)
    b = np.zeros(20)
    b[3] = 1.0
    jr = jls.minres(jop, b, 0.5, rtol=1e-14, maxiter=100)
    tr = tls.minres(top, torch.as_tensor(b), 0.5, rtol=1e-14, maxiter=100)
    _compare(jr, tr)
    assert tr.iterations == 1
    np.testing.assert_allclose(as_np(tr.x)[3], 1.0 / (0.5 - 4.0))


@pytest.mark.parametrize("precond", [None, "jacobi"])
def test_minres_on_block_sparse_operator_matches_jax(precond):
    H = banded(256, bw=4, seed=3)
    evE = np.linalg.eigvalsh(H)
    sigma = float(evE[128] + 0.2 * (evE[129] - evE[128]))
    jop = JaxBSR.from_dense(H, block_size=64, use_pallas=False)
    top = torch_op(jop)
    b = np.random.RandomState(4).rand(256)
    jr = jls.minres(jop, b, sigma, rtol=1e-6, maxiter=4000, precond=precond)
    tr = tls.minres(top, torch.as_tensor(b), sigma, rtol=1e-6, maxiter=4000,
                    precond=precond)
    _compare(jr, tr, xtol=1e-6)


def test_f32_solve_matches_jax_at_f32_tolerance():
    """f32 data: both reach the requested 1e-4 residual; solutions agree
    to the f32 solve tolerance scale (1e-3 relative)."""
    A = dd_matrix(200, seed=7).astype(np.float32)
    jop, top = _pair(A)
    b = np.random.RandomState(2).rand(200).astype(np.float32)
    jr = jls.minres(jop, b, 35.0, rtol=1e-4, maxiter=2000, precond="jacobi")
    tr = tls.minres(top, torch.as_tensor(b), 35.0, rtol=1e-4, maxiter=2000,
                    precond="jacobi")
    assert tr.x.dtype == torch.float32 and tr.converged and bool(jr.converged)
    xj = np.asarray(jr.x)
    assert np.abs(as_np(tr.x) - xj).max() <= 1e-3 * np.abs(xj).max()


def test_unknown_preconditioner_raises():
    top = torch_op(jax_as_operator(dd_matrix(16)))
    with pytest.raises(ValueError, match="preconditioner"):
        tls.minres(top, torch.ones(16, dtype=torch.float64), 5.0,
                   precond="ilu")
