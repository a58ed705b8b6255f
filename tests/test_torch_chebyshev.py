"""The port's Chebyshev-filtered window solver
(``chebyshevFilteredDiagonalization`` and its pieces) against the JAX
package on the same numpy inputs.

Problems: tests/test_chebyshev.py's n = 100 matrix with eigenvalues
linspace(1, 200) and the window [160, 166] (three levels), and a small
slice of the chip smoke operator (``kron_sum_bsr``: an outer basis of 64,
an inner DVR of 16, n = 1024), which runs the block-sparse route (the lane
product B3's plain version) with the window of levels 18..23.  The JAX BSR
runs its CPU path (``use_pallas=False``), as tests/test_sparse.py does.

Tolerances:
* coefficients and ``adaptive_degree``: equal;
* ``estimate_spectral_bounds`` in f64: 1e-10 relative;
* ``_filter_stack`` in f64, degree 50, dense and BSR: 1e-10 relative;
* the fused window with an f64 state: ``ev`` and ``vecResiduals`` 1e-8,
  ``outerIter`` and ``degree`` equal; no subspace row dies in either
  package, so the replacement rows (drawn differently by the two) never
  enter;
* the fused window in f32 (tests/test_chebyshev.py's case): both within
  1e-4 of the exact levels, outer iterations within one;
* ``writeOut=True``: the same file names, ``ev`` to 1e-8 in f64.
Ritz vectors are compared through their residuals, never entry by entry
(their signs differ)."""

import numpy as np
import pytest
import scipy.linalg as la
import torch

import jax
import jax.numpy as jnp
from eigensolvers_tpu import JaxVector
from eigensolvers_tpu import as_operator as jax_as_operator
from eigensolvers_tpu.ops.sparse import BSROperator as JaxBSR
from eigensolvers_tpu.solvers import chebyshev as jc

from eigensolvers_tpu_torch import (TorchVector,
                                    chebyshevFilteredDiagonalization,
                                    select_within_range)
from eigensolvers_tpu_torch.models import product
from eigensolvers_tpu_torch.ops.operators import DenseOperator
from eigensolvers_tpu_torch.solvers import chebyshev as tc
from test_torch_common import CPU, as_np

RMIN, RMAX = 160.0, 166.0


@pytest.fixture(scope="module")
def dense():
    n = 100
    ev = np.linspace(1, 200, n)
    Q = la.qr(np.random.RandomState(10).rand(n, n))[0]
    A = Q.T @ np.diag(ev) @ Q
    return dict(A=A, ev=ev, n=n, eMin=RMIN, eMax=RMAX,
                jop=jax_as_operator(A), top=DenseOperator(A, device=CPU))


@pytest.fixture(scope="module")
def bsr_slice():
    """The smoke slice at an outer basis of 64 and an inner DVR of 16, and
    the window whose edges lie halfway between levels 17|18 and 23|24."""
    H_out = product.anharmonic_oscillator_fbr(64, 1.0, 1e-3)
    h_in = product.sinc_dvr_oscillator(16, 1.3, (-7.0, 7.0))
    levels = product.kron_sum_levels(np.linalg.eigvalsh(H_out),
                                     np.linalg.eigvalsh(h_in), 25)
    top = product.kron_sum_bsr(H_out, h_in, 4, device=CPU)
    jop = JaxBSR(as_np(top.data), as_np(top.idx), top.n, use_pallas=False)
    return dict(ev=levels, n=top.n, jop=jop, top=top,
                eMin=0.5 * (levels[17] + levels[18]),
                eMax=0.5 * (levels[23] + levels[24]))


def _guesses(n, m0, seed, dtype=np.float64):
    Y = la.qr(np.random.RandomState(seed).rand(n, m0), mode="economic")[0]
    Y = Y.astype(dtype)
    return ([JaxVector(Y[:, i], {}) for i in range(m0)],
            [TorchVector(Y[:, i], {}, device=CPU) for i in range(m0)])


def _residuals(A, ev, vecs):
    """||A v - lambda v|| of each unit-normalized returned vector."""
    out = []
    for lam, v in zip(ev, vecs):
        x = np.asarray(as_np(v.array), np.float64).ravel()
        x = x / np.linalg.norm(x)
        out.append(np.linalg.norm(A(x) - lam * x))
    return np.array(out)


@pytest.mark.parametrize("degree,a,b,lo,hi,jackson", [
    (400, -1.2, 1.2, 0.1, 0.4, True), (150, -47.4, 248.4, 160.0, 166.0, True),
    (37, 0.0, 10.0, 2.0, 9.5, False), (8000, 1.15, 18749.5, 6.91, 7.92, True)])
def test_window_coefficients_equal(degree, a, b, lo, hi, jackson):
    np.testing.assert_array_equal(
        tc.chebyshev_window_coefficients(degree, a, b, lo, hi, jackson),
        jc.chebyshev_window_coefficients(degree, a, b, lo, hi, jackson))
    with pytest.raises(ValueError, match="inside"):
        tc.chebyshev_window_coefficients(50, 0.0, 1.0, 0.5, 1.5)


@pytest.mark.parametrize("a,b,lo,hi", [
    (-47.4, 248.4, 160.0, 166.0), (0.0, 1.0, 0.4, 0.6),
    (1.15, 18749.5, 6.914116, 7.924456), (-1.0, 1.0, -1e-9, 1e-9)])
def test_adaptive_degree_equal(a, b, lo, hi):
    assert tc.adaptive_degree(a, b, lo, hi) == jc.adaptive_degree(a, b, lo,
                                                                  hi)


@pytest.mark.parametrize("problem", ["dense", "bsr_slice"])
def test_spectral_bounds_match_jax(problem, request):
    p = request.getfixturevalue(problem)
    got = tc.estimate_spectral_bounds(p["top"], p["n"])
    want = jc.estimate_spectral_bounds(p["jop"], p["n"])
    np.testing.assert_allclose(got, want, rtol=1e-10)
    assert got[0] <= p["ev"][0] and got[1] >= p["ev"][-1]


@pytest.mark.parametrize("problem", ["dense", "bsr_slice"])
def test_filter_stack_matches_jax(problem, request):
    p = request.getfixturevalue(problem)
    a, b = jc.estimate_spectral_bounds(p["jop"], p["n"])
    cf = jc.chebyshev_window_coefficients(50, a, b, p["eMin"], p["eMax"])
    W = la.qr(np.random.RandomState(3).rand(p["n"], 6),
              mode="economic")[0].T.copy()
    want = np.asarray(jc._filter_stack(p["jop"], jnp.asarray(W), cf, a, b))
    got = as_np(tc._filter_stack(p["top"], torch.as_tensor(W), cf, a, b))
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


def _nan_pools(monkeypatch):
    """Replacement rows of NaN in both packages: a row that died would
    carry NaN into every later result.  The JAX driver traces a fresh
    wrapper of its fused program, so the patched draw is the one traced."""
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=float: jnp.full(
                            shape, jnp.nan, dtype))
    impl = jc._fused_window_impl
    monkeypatch.setattr(jc, "_fused_window_impl", lambda *a: impl(*a))
    monkeypatch.setattr(jc, "_FUSED_WINDOW", None)
    monkeypatch.setattr(tc, "_replenishment_pool",
                        lambda shape, dtype, device: torch.full(
                            shape, float("nan"), dtype=dtype, device=device))


@pytest.mark.parametrize("problem,m0,degree", [("dense", 6, 150),
                                               ("bsr_slice", 10, 600)])
def test_fused_window_f64_matches_jax(problem, m0, degree, request,
                                      monkeypatch):
    """Both packages run with NaN replacement rows (see _nan_pools), so
    finite results show that no row died in either."""
    p = request.getfixturevalue(problem)
    _nan_pools(monkeypatch)
    jv, tv = _guesses(p["n"], m0, 3)
    args = (degree, p["eMin"], p["eMax"], 1e-10, 40)
    evj, _, stj = jc.chebyshevFilteredDiagonalization(p["jop"], jv, *args,
                                                      writeOut=False)
    evt, vt, stt = chebyshevFilteredDiagonalization(p["top"], tv, *args,
                                                    writeOut=False)
    assert np.all(np.isfinite(np.asarray(evj))) and np.all(np.isfinite(evt))
    np.testing.assert_allclose(evt, np.asarray(evj), rtol=0, atol=1e-8)
    np.testing.assert_allclose(stt["vecResiduals"], stj["vecResiduals"],
                               rtol=0, atol=1e-8)
    assert stt["outerIter"] == stj["outerIter"]
    assert stt["degree"] == stj["degree"] == degree
    assert stt["isConverged"] and stj["isConverged"]
    assert set(stt) == set(stj)
    inside = select_within_range(p["ev"], p["eMin"], p["eMax"])[0]
    for level in inside:
        assert np.min(np.abs(evt - level)) <= 1e-8 * max(1.0, abs(level))
    assert vt[0].dtype == torch.float64 and len(vt) == m0
    np.testing.assert_allclose(
        _residuals(lambda x: as_np(p["top"].matvec(torch.as_tensor(x))),
                   evt, vt), stt["vecResiduals"], rtol=1e-6, atol=1e-12)


def test_fused_window_f32_matches_jax_and_exact(dense):
    """tests/test_chebyshev.py::test_fused_path_status_certificate's case:
    f32 state and operator, the adaptive degree, eConv 1e-6."""
    p = dense
    m0 = 8
    jv, tv = _guesses(p["n"], m0, 3, np.float32)
    A32 = p["A"].astype(np.float32)
    args = (None, RMIN, RMAX, 1e-6, 30)
    evj, _, stj = jc.chebyshevFilteredDiagonalization(
        jax_as_operator(A32), jv, *args, writeOut=False)
    evt, vt, stt = chebyshevFilteredDiagonalization(
        DenseOperator(A32, device=CPU), tv, *args, writeOut=False)
    inside = select_within_range(p["ev"], RMIN, RMAX)[0]
    assert len(inside) == 3
    for ev in (np.asarray(evj), evt):
        for level in inside:
            assert np.min(np.abs(ev - level)) <= 1e-4
    assert abs(stt["outerIter"] - stj["outerIter"]) <= 1
    assert stt["degree"] == stj["degree"] > 0
    vres = stt["vecResiduals"]
    assert vres.shape == (m0,)
    in_win = (evt >= RMIN) & (evt <= RMAX)
    assert float(vres[in_win].max()) < 1e-2 * RMAX


def test_write_out_path_matches_jax(dense, tmp_path, monkeypatch):
    """The host loop with per-iteration reports, ending in one f64
    polish iteration: the same files and the same levels."""
    p = dense
    m0 = 6
    found = {}
    for name, fn, op, vecs in (
            ("jax", jc.chebyshevFilteredDiagonalization, p["jop"],
             _guesses(p["n"], m0, 4)[0]),
            ("torch", chebyshevFilteredDiagonalization, p["top"],
             _guesses(p["n"], m0, 4)[1])):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        ev, vecs, st = fn(op, vecs, 150, RMIN, RMAX, 1e-10, 40,
                          writeOut=True)
        found[name] = (np.asarray(ev), st,
                       sorted(f.name for f in d.iterdir()))
    (evj, stj, fj), (evt, stt, ft) = found["jax"], found["torch"]
    assert ft == fj == ["iterations_feast.out", "summary_feast.out"]
    np.testing.assert_allclose(evt, evj, rtol=0, atol=1e-8)
    assert stt["outerIter"] == stj["outerIter"]
    assert stt["isConverged"] and stj["isConverged"]
    summary = (tmp_path / "torch" / "summary_feast.out").read_text()
    assert "startingPoint" in summary and "endingPoint" in summary


def test_dead_rows_take_unit_rows_and_the_sentinel(dense):
    """The port alone (the replacement rows are its own draws): a subspace
    wider than the filter's pass band loses rank in one round; each dead
    row becomes its unit replacement row and carries the out-of-window
    sentinel; live rows are unit-norm Ritz vectors."""
    p = dense
    a, b = tc.estimate_spectral_bounds(p["top"], p["n"])
    cf = tc.chebyshev_window_coefficients(1000, a, b, RMIN, RMAX)
    W = torch.as_tensor(la.qr(np.random.RandomState(5).rand(p["n"], 40),
                              mode="economic")[0].T.copy())
    R0 = tc._replenishment_pool(W.shape, W.dtype, W.device)
    Wn, ev = tc._rr_round(p["top"], W, cf, a, b, R0)
    sentinel = abs(a + b) * 0.5 + 1e3 * abs(b - a) * 0.5 + 1e6
    dead = as_np(ev) == sentinel
    assert 0 < dead.sum() < 40
    np.testing.assert_array_equal(as_np(Wn)[dead], as_np(R0)[dead])
    np.testing.assert_allclose(np.linalg.norm(as_np(Wn), axis=1), 1.0,
                               atol=1e-12)
    assert np.all(as_np(ev)[~dead] < 1e3)
    np.testing.assert_allclose(
        np.linalg.norm(as_np(R0), axis=1), 1.0, atol=1e-12)
    # the next round's residual mask never counts the sentinel rows
    res = tc._window_residual(ev, ev, RMIN, RMAX)
    assert float(res) == 0.0


def test_array_backed_backend_required():
    class Compressed:
        options = {}
    with pytest.raises(TypeError, match="array-backed"):
        chebyshevFilteredDiagonalization(None, [Compressed()], 10, 0.0, 1.0,
                                         1e-6, 1)
