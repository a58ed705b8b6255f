"""The port's spectrum slicing (KPM moments, window counts, load-balanced
boundaries and the windowed FEAST sweep) against the JAX package on the
same numpy inputs.

Problems: tests/test_slicing.py's n = 240 ``known_spectrum_matrix`` with
eigenvalues linspace(1, 480), and the small smoke slice of
tests/test_torch_chebyshev.py (``kron_sum_bsr``, outer basis 64, inner DVR
16), whose moments run through the lane product B3's plain version.

Tolerances:
* ``chebyshev_moments`` in f64: 1e-10 (and the bounds 1e-10 relative);
* counts, the KPM CDF and ``partition_windows`` boundaries: 1e-8
  relative;
* the full sweep (tests/test_slicing.py's 3-window case): the same
  ``found_total`` and ``dropped_spurious``, ``ev`` to 1e-6."""

import numpy as np
import pytest
import torch

from eigensolvers_tpu.ops.sparse import BSROperator as JaxBSR
from eigensolvers_tpu.solvers import slicing as js
from eigensolvers_tpu.models.synthetic import known_spectrum_matrix

from eigensolvers_tpu_torch import spectrumSlicingDiagonalization
from eigensolvers_tpu_torch.models import product
from eigensolvers_tpu_torch.ops.operators import DenseOperator
from eigensolvers_tpu_torch.solvers import slicing as ts
from test_torch_common import CPU, as_np


@pytest.fixture(scope="module")
def problem():
    n = 240
    H, ev = known_spectrum_matrix(n, eigenvalues=np.linspace(1, 2 * n, n),
                                  seed=10)
    return np.asarray(H), np.asarray(ev), n


@pytest.fixture(scope="module")
def moments(problem):
    H, _, n = problem
    kw = dict(degree=400, nProbes=12, seed=3, dtype=np.float64)
    return (js.chebyshev_moments(H, n, **kw),
            ts.chebyshev_moments(DenseOperator(H, device=CPU), n, **kw))


def test_moments_match_jax(problem, moments):
    _, ev, _ = problem
    (muj, bj), (mut, bt) = moments
    np.testing.assert_allclose(bt, bj, rtol=1e-10)
    np.testing.assert_allclose(mut, muj, rtol=0, atol=1e-10)
    assert mut.dtype == np.float64 and mut.shape == (401,)
    assert bt[0] <= ev[0] and bt[1] >= ev[-1]


def test_moments_on_the_bsr_slice_match_jax():
    """The probe stack through the block-sparse lane product; f32 probes
    on the f64 operator are cast back to f32 each step, as in the JAX
    package (checked at f32 roundoff), f64 probes at 1e-10."""
    H_out = product.anharmonic_oscillator_fbr(64, 1.0, 1e-3)
    h_in = product.sinc_dvr_oscillator(16, 1.3, (-7.0, 7.0))
    top = product.kron_sum_bsr(H_out, h_in, 4, device=CPU)
    jop = JaxBSR(as_np(top.data), as_np(top.idx), top.n, use_pallas=False)
    for dtype, tol in ((np.float64, 1e-10), (np.float32, 1e-4)):
        kw = dict(degree=300, nProbes=8, seed=3, dtype=dtype)
        muj, bj = js.chebyshev_moments(jop, top.n, **kw)
        mut, bt = ts.chebyshev_moments(top, top.n, **kw)
        np.testing.assert_allclose(bt, bj, rtol=1e-10)
        np.testing.assert_allclose(mut, muj, rtol=0, atol=tol)


@pytest.mark.parametrize("lo,hi", [(100.0, 200.0), (30.0, 90.0),
                                   (350.0, 470.0), (160.25, 208.25)])
def test_window_counts_match_jax(problem, moments, lo, hi):
    _, ev, n = problem
    (muj, (aj, bj)), (mut, (at, bt)) = moments
    est = ts.window_count_from_moments(mut, at, bt, lo, hi, n)
    want = js.window_count_from_moments(muj, aj, bj, lo, hi, n)
    assert est == pytest.approx(want, rel=1e-8)
    exact = int(np.sum((ev >= lo) & (ev <= hi)))
    assert abs(est - exact) <= max(3.0, 0.15 * exact)


def test_partition_and_density_match_jax(problem, moments):
    _, ev, n = problem
    (muj, (aj, bj)), (mut, (at, bt)) = moments
    got = ts.partition_windows(mut, at, bt, 50.0, 430.0, 4, n)
    want = js.partition_windows(muj, aj, bj, 50.0, 430.0, 4, n)
    np.testing.assert_allclose(got, want, rtol=1e-8)
    assert got[0] == 50.0 and got[-1] == 430.0 and np.all(np.diff(got) > 0)
    xs, cdf = ts.estimate_spectral_density(mut, at, bt, n, nGrid=100)
    xj, cdfj = js.estimate_spectral_density(muj, aj, bj, n, nGrid=100)
    np.testing.assert_allclose(xs, xj, rtol=1e-8)
    np.testing.assert_allclose(cdf, cdfj, rtol=1e-8, atol=1e-8)
    assert np.all(np.diff(cdf) >= 0) and abs(cdf[-1] - n) < 0.05 * n


def test_full_sweep_matches_jax(problem):
    """tests/test_slicing.py's 3-window sweep over 24 levels in both
    packages: every level once, the same counts, and the port's polished
    pairs at true vector-residual quality."""
    H, ev, n = problem
    eMin, eMax = 160.25, 208.25
    exact = ev[(ev >= eMin) & (ev <= eMax)]
    kw = dict(nWindows=3, nc=8, eConv=1e-8, maxit=12, degree=400,
              nProbes=12, seed=5)
    evj, _, stj = js.spectrumSlicingDiagonalization(H, eMin, eMax, **kw)
    evt, vt, stt = spectrumSlicingDiagonalization(H, eMin, eMax,
                                                  device=CPU, **kw)
    assert stt["found_total"] == stj["found_total"] == len(exact) == 24
    assert stt["dropped_spurious"] == stj["dropped_spurious"]
    np.testing.assert_allclose(evt, np.asarray(evj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(evt, exact, rtol=0, atol=1e-4)
    assert stt["isConverged"] and set(stt) == set(stj)
    assert [w["m0"] for w in stt["windows"]] == \
        [w["m0"] for w in stj["windows"]]
    assert stt["residuals"].max() < 1e-5
    for i in (0, len(evt) // 2, len(evt) - 1):
        x = as_np(vt[i].array).astype(np.float64)
        assert np.linalg.norm(H @ x - evt[i] * x) < 1e-5
        assert vt[i].array.device == CPU


def test_explicit_windows_must_span_the_interval(problem):
    H, _, _ = problem
    with pytest.raises(ValueError, match="eMin to eMax"):
        spectrumSlicingDiagonalization(H, 100.5, 140.5,
                                       windows=[100.0, 120.5, 140.5],
                                       degree=50, device=CPU)


def test_sweep_places_host_data_on_the_requested_device():
    """A numpy ``A`` goes to ``device`` (the card by default, which this
    CPU host lacks); an operator keeps its own device."""
    H = np.diag(np.arange(1.0, 9.0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            spectrumSlicingDiagonalization(H, 2.5, 4.5, degree=50)
    ev, vecs, st = spectrumSlicingDiagonalization(
        DenseOperator(H, device=CPU), 2.5, 4.5, nWindows=1, degree=60,
        maxit=4, eConv=1e-6)
    assert vecs[0].array.device == CPU
    np.testing.assert_allclose(ev, [3.0, 4.0], atol=1e-8)
