"""The port's copy of the host numpy backend (``vectors/numpy_backend.py``)
against the JAX package's: the same arrays in, the same numbers out (it
is host numpy/scipy in both, so to 1e-12; the Lanczos eigenvalue to
1e-10)."""

import numpy as np
import pytest

import eigensolvers_tpu as J
from eigensolvers_tpu.vectors.numpy_backend import NumpyVector as JNV

import eigensolvers_tpu_torch as T
from eigensolvers_tpu_torch.vectors.numpy_backend import NumpyVector as TNV

from test_torch_common import dd_matrix


@pytest.fixture(scope="module")
def problem():
    A = dd_matrix(60, seed=3)
    rng = np.random.RandomState(1)
    return A, [rng.standard_normal(60) for _ in range(4)]


def test_exported_where_the_jax_package_exports_it():
    assert T.NumpyVector is TNV


def test_collectives_match(problem):
    A, xs = problem
    jv, tv = [JNV(x) for x in xs], [TNV(x) for x in xs]
    for a, b in zip(JNV.orthogonalize(jv), TNV.orthogonalize(tv)):
        np.testing.assert_allclose(b.array, a.array, rtol=0, atol=1e-12)
    np.testing.assert_allclose(TNV.overlapMatrix(tv), JNV.overlapMatrix(jv),
                               rtol=1e-12)
    np.testing.assert_allclose(TNV.matrixRepresentation(A, tv),
                               JNV.matrixRepresentation(A, jv), rtol=1e-12)
    np.testing.assert_allclose(
        TNV.linearCombination(tv, [1.0, -2.0, 0.5, 3.0]).array,
        JNV.linearCombination(jv, [1.0, -2.0, 0.5, 3.0]).array, rtol=1e-12)
    a = TNV.orthogonalize_against_set(tv[3], tv[:2])
    b = JNV.orthogonalize_against_set(jv[3], jv[:2])
    np.testing.assert_allclose(a.array, b.array, rtol=0, atol=1e-12)


@pytest.mark.parametrize("solver,sigma", [("minres", 30.0),
                                          ("gcrotmk", 30.0 + 2.0j),
                                          ("exact", 30.0)])
def test_solve_matches(problem, solver, sigma):
    A, xs = problem
    opts = {"linearSystemArgs": {"linearSolver": solver, "linear_tol": 1e-10,
                                 "linear_atol": 1e-12}}
    a = TNV.solve(A, TNV(xs[0], opts), sigma)
    b = JNV.solve(A, JNV(xs[0], opts), sigma)
    np.testing.assert_allclose(a.array, b.array, rtol=0,
                               atol=1e-12 * np.abs(b.array).max())


def test_lanczos_matches(problem):
    A, xs = problem
    ev = np.linalg.eigvalsh(A)
    sigma = float((ev[10] + ev[11]) / 2 + 0.1)
    opts = {"linearSystemArgs": {"linear_tol": 1e-8, "linear_atol": 1e-10}}
    got = []
    for pkg, cls in ((J, JNV), (T, TNV)):
        e, _, _ = pkg.inexactLanczosDiagonalization(
            A, cls(xs[0], opts), sigma, 10, 6, 1e-10, writeOut=False)
        got.append(pkg.find_nearest(e, sigma)[1])
    assert abs(got[1] - got[0]) <= 1e-10 * abs(got[0])
    assert abs(got[1] - J.find_nearest(ev, sigma)[1]) <= 1e-8 * abs(got[0])
