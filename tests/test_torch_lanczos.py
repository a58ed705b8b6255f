"""The slice as a whole: ``inexactLanczosDiagonalization`` in both
packages on the same sparse problems, from the same guess.

* the banded problem of tests/test_sparse.py::test_lanczos_on_sparse
  (n = 256, B = 64);
* the chip smoke problem (H = H_out ⊗ I + I ⊗ h_in, a quartic-perturbed
  HO outer mode and a sinc-DVR inner mode) shrunk to an outer basis of 16
  and an inner DVR of 32, with its exact Kronecker-sum spectrum.

Tolerance: f64 runs; the nearest eigenvalue agrees with the JAX run and
with the exact level to 1e-6 relative (eConv 1e-7 / 1e-9 Lanczos
convergence, inexact 1e-4 inner solves).  Both write byte-compatible
report files: the same sentinels, header block and columns."""

import os

import numpy as np
import pytest
import torch

from eigensolvers_tpu import JaxVector
from eigensolvers_tpu import inexactLanczosDiagonalization as jax_lanczos
from eigensolvers_tpu.ops.sparse import BSROperator as JaxBSR

from eigensolvers_tpu_torch import TorchVector, find_nearest
from eigensolvers_tpu_torch import inexactLanczosDiagonalization as lanczos
from eigensolvers_tpu_torch.config import LanczosConfig
from eigensolvers_tpu_torch.models import product
from eigensolvers_tpu_torch.ops import sparse as bsr
from test_torch_common import as_np, banded, torch_op, torch_vec

OPTS = {"linearSystemArgs": {"linearSolver": "minres", "linearIter": 4000,
                             "linear_tol": 1e-4,
                             "errorOnNonConvergence": False}}


def _run_both(jop, guess, sigma, L, maxit, eConv, tmp_path, opts=OPTS):
    out = {}
    jv = JaxVector(guess, opts)
    tv = torch_vec(jv, opts)
    for name, fn, op, vec in (("jax", jax_lanczos, jop, jv),
                              ("torch", lanczos, torch_op(jop), tv)):
        d = tmp_path / name
        d.mkdir()
        ev, Y, st = fn(op, vec, sigma, L, maxit, eConv, writeOut=True,
                       outFileName=str(d / "iterations_lanczos.out"),
                       summaryFileName=str(d / "summary_lanczos.out"))
        out[name] = (np.asarray(ev), Y, st, d)
    return out["jax"], out["torch"]


def _lines(path):
    with open(path) as f:
        return f.read().splitlines()


def _check_reports(djax, dtorch):
    sj = _lines(djax / "summary_lanczos.out")
    stt = _lines(dtorch / "summary_lanczos.out")
    for s in (sj, stt):
        assert s[0] == "startingPoint" and s.count("endingPoint") == 1
    # header block (between the date stamps) and the column header line
    head_j = [ln for ln in sj if "::" in ln or ln.startswith("pick")]
    head_t = [ln for ln in stt if "::" in ln or ln.startswith("pick")]
    assert head_j == head_t and head_j
    cols_j = [ln for ln in sj if ln.lstrip().startswith("it ")]
    cols_t = [ln for ln in stt if ln.lstrip().startswith("it ")]
    assert cols_j == cols_t and len(cols_j) == 1
    ncol = len(cols_j[0].split())
    rows_t = stt[stt.index(cols_t[0]) + 1:stt.index("endingPoint")]
    assert rows_t and all(len(r.split()) == ncol for r in rows_t)
    it_j = "\n".join(_lines(djax / "iterations_lanczos.out"))
    it_t = "\n".join(_lines(dtorch / "iterations_lanczos.out"))
    for marker in ("Info per iteration", "OVERLAP MATRIX",
                   "HAMILTONIAN MATRIX", "FINAL RESULTS",
                   "Target, Lanczos (nearest)", "End of computation"):
        assert marker in it_j and marker in it_t, marker


def test_banded_sparse_problem_matches_jax(tmp_path):
    n = 256
    H = banded(n, bw=4, seed=3)
    evE = np.linalg.eigvalsh(H)
    target = float(evE[n // 2] + 0.2 * (evE[n // 2 + 1] - evE[n // 2]))
    jop = JaxBSR.from_dense(H, block_size=64, use_pallas=False)
    guess = np.random.RandomState(4).rand(n)
    (evj, _, stj, dj), (evt, Yt, stt, dt) = _run_both(
        jop, guess, target, 20, 8, 1e-7, tmp_path)
    want = find_nearest(evE, target)[1]
    got_j = find_nearest(evj, target)[1]
    got_t = find_nearest(evt, target)[1]
    assert abs(got_t - got_j) <= 1e-6 * abs(got_j)
    assert abs(got_t - want) <= 1e-6 * abs(want)
    assert set(stt) == set(stj)
    assert isinstance(Yt[0], TorchVector) and Yt[0].shape == (n,)
    _check_reports(dj, dt)


def _smoke_problem(M=16, B=32):
    H_out = product.anharmonic_oscillator_fbr(M, 1.0, 1e-3)
    h_in = product.sinc_dvr_oscillator(B, 1.3, (-7.0, 7.0))
    levels = product.kron_sum_levels(np.linalg.eigvalsh(H_out),
                                     np.linalg.eigvalsh(h_in), 22)
    sigma = float(levels[20] + 0.2 * (levels[21] - levels[20]))
    xg = np.linspace(-7.0, 7.0, B)
    packets = np.stack([xg ** p * np.exp(-xg ** 2 / 2) for p in range(4)])
    guess = np.zeros((M, B))
    guess[:8] = np.random.RandomState(0).standard_normal((8, 4)) @ packets
    return H_out, h_in, levels, sigma, guess.reshape(-1)


def test_product_operator_matches_kronecker_sum():
    H_out, h_in, levels, _, _ = _smoke_problem()
    op = product.kron_sum_bsr(H_out, h_in, 4)
    assert tuple(op.dataT.shape) == (16, 9, 32, 32)
    dense = np.kron(H_out, np.eye(32)) + np.kron(np.eye(16), h_in)
    np.testing.assert_allclose(as_np(op.to_dense()), dense, atol=1e-12)
    np.testing.assert_allclose(np.linalg.eigvalsh(dense)[:22], levels,
                               atol=1e-9)
    with pytest.raises(ValueError, match="bandwidth"):
        product.kron_sum_bsr(H_out, h_in, 3)


def test_smoke_problem_matches_jax_and_exact(tmp_path):
    H_out, h_in, levels, sigma, guess = _smoke_problem()
    mine = product.kron_sum_bsr(H_out, h_in, 4)
    jop = JaxBSR(np.swapaxes(as_np(mine.dataT), 2, 3), as_np(mine.idx),
                 mine.n, use_pallas=False)
    opts = {"linearSystemArgs": dict(OPTS["linearSystemArgs"],
                                     preconditioner="jacobi")}
    (evj, _, stj, dj), (evt, _, stt, dt) = _run_both(
        jop, guess, sigma, 12, 8, 1e-9, tmp_path, opts)
    exact = levels[20]
    assert abs(find_nearest(evt, sigma)[1] - exact) <= 1e-6 * exact
    assert abs(find_nearest(evj, sigma)[1] - exact) <= 1e-6 * exact
    assert set(stt) == set(stj)
    _check_reports(dj, dt)


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_smoke_problem_f32_through_lanczos_config(precision):
    """The f32 slice as chip_smoke.py runs it, on the CPU plain versions
    (LanczosConfig entry point, no files).  f32 tolerance: 1e-5 relative
    for "highest"; bf16x3 ("high") represents each block element to 2^-16
    relative and the DVR kinetic blocks cancel to small energies, so its
    bound is 2e-4."""
    H_out, h_in, levels, sigma, guess = _smoke_problem()
    op = product.kron_sum_bsr(H_out, h_in, 4, dtype=torch.float32,
                              precision=precision)
    report = {}
    opts = {"linearSystemArgs": dict(OPTS["linearSystemArgs"], linear_tol=1e-2,
                                     linear_atol=1e-2,
                                     preconditioner="jacobi", report=report)}
    bsr.reset_launch_counts()
    ev, Y, st = LanczosConfig(sigma=sigma, L=12, maxit=8, eConv=1e-7,
                              checkFitTol=1e-5, writeOut=False).run(
        op, TorchVector(guess.astype(np.float32), opts))
    tol = 1e-5 if precision == "highest" else 2e-4
    assert abs(find_nearest(ev, sigma)[1] - levels[20]) <= tol * levels[20]
    assert Y[0].dtype == torch.float32
    assert report["matvecs"] > 0 and st["timers"]["solve"]["calls"] > 0
    assert set(bsr.launches.values()) == {0}
