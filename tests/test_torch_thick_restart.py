"""Thick restart (``thickRestart``) in the port against the JAX package, on
the three cases of tests/test_thick_restart.py, on the CPU: both packages
get the same matrix and guess (numpy, from the same seeds) and run
``inexactLanczosDiagonalization`` with the same arguments.

* the interior configuration (n = 400, L = 3, sigma = 190.3) with
  ``thickRestart`` True and False: the same restarts, cumIter and outer
  iterations in both packages (3 restarts / 7 iterations without thick
  restart, 2 / 6 with it), fewer restarts with it;
* the same runs' levels: as many Ritz values in both packages, and the
  one nearest sigma, the converged one, equal to 1e-9 absolute, the
  runs' eConv (measured: 1.4e-11 without thick restart, 1.3e-10 with
  it; the packages sum in other orders, and the other, unconverged Ritz
  values carry the inexact solves' error, up to 1.3e-3 apart) and within
  1e-6 of the exact level;
* the lindep case (loose GMRES solves, sigma near the top edge, an
  unreachable eConv): both packages flag ``lindep``, end through the
  futile-restart counter before maxit, with the same counts.
"""

import numpy as np
import pytest
import scipy.linalg as la
import torch

from eigensolvers_tpu import JaxVector
from eigensolvers_tpu import inexactLanczosDiagonalization as jax_lanczos
from eigensolvers_tpu.models.synthetic import known_spectrum_matrix

from eigensolvers_tpu_torch import inexactLanczosDiagonalization as lanczos
from test_torch_common import torch_vec

SIGMA = 190.3
EV_ATOL = 1e-9           # the converged level nearest sigma: eConv


def _run_both(H, guess, opts, sigma, **kw):
    """(levels, status) of the JAX package and of the port on the same
    matrix and guess."""
    out = {}
    jv = JaxVector(guess, opts)
    for name, fn, op, vec in (
            ("jax", jax_lanczos, np.asarray(H), jv),
            ("torch", lanczos, torch.as_tensor(np.asarray(H)),
             torch_vec(jv, opts))):
        ev, _, st = fn(op, vec, sigma, writeOut=False, **kw)
        out[name] = (np.asarray(ev, dtype=float), st)
    return out["jax"], out["torch"]


def _interior(thick):
    H, ev = known_spectrum_matrix(400, eigenvalues=np.linspace(1, 400, 400),
                                  seed=5)
    opts = {"linearSystemArgs": {
        "linearSolver": "minres", "linearIter": 3000, "linear_tol": 1e-5,
        "errorOnNonConvergence": False}}
    guess = np.random.RandomState(3).rand(400)
    return np.asarray(ev), _run_both(H, guess, opts, SIGMA, L=3, maxit=30,
                                     eConv=1e-9, thickRestart=thick)


def _nearest(levels, sigma):
    return float(levels[np.argmin(np.abs(levels - sigma))])


@pytest.fixture(scope="module")
def interior_runs():
    return {thick: _interior(thick) for thick in (False, True)}


@pytest.mark.parametrize("thick", [False, True])
def test_restart_counts_match_the_jax_package(interior_runs, thick):
    _, ((_, sj), (_, st)) = interior_runs[thick]
    assert sj["isConverged"] and st["isConverged"]
    for key in ("restarts", "cumIter", "outerIter"):
        assert st[key] == sj[key], (key, st[key], sj[key])


def test_thick_restart_takes_fewer_restarts_in_the_port(interior_runs):
    """The JAX package's own contract, held by the port: 3 -> 2 restarts,
    7 -> 6 cumulative iterations."""
    st_simple = interior_runs[False][1][1][1]
    st_thick = interior_runs[True][1][1][1]
    assert (st_simple["restarts"], st_simple["cumIter"]) == (3, 7)
    assert (st_thick["restarts"], st_thick["cumIter"]) == (2, 6)


@pytest.mark.parametrize("thick", [False, True])
def test_levels_match_the_jax_package(interior_runs, thick):
    exact, ((evj, _), (evt, _)) = interior_runs[thick]
    assert len(evt) == len(evj)
    assert abs(_nearest(evt, SIGMA) - _nearest(evj, SIGMA)) <= EV_ATOL
    assert abs(_nearest(evt, SIGMA) - _nearest(exact, SIGMA)) < 1e-6


def test_lindep_contract_matches_the_jax_package():
    n = 600
    ev = np.linspace(1, 400, n)
    rng = np.random.RandomState(10)
    Q = la.qr(rng.rand(n, n))[0]
    A = Q.T @ np.diag(ev) @ Q
    opts = {"linearSystemArgs": {
        "linearSolver": "gcrotmk", "linearIter": 300, "linear_tol": 1e-1,
        "errorOnNonConvergence": False}}
    guess = np.random.RandomState(11).rand(n)
    with pytest.warns(UserWarning):
        (_, sj), (_, st) = _run_both(A, guess, opts, 390, L=8, maxit=60,
                                     eConv=1e-18, thickRestart=True)
    for s in (sj, st):
        assert s["lindep"] is True
        assert s["futileRestarts"] > 3
        assert s["outerIter"] < 59
    for key in ("futileRestarts", "outerIter", "restarts"):
        assert st[key] == sj[key], (key, st[key], sj[key])
