"""The dense and tensor-network demos against their JAX counterparts.

Each of ``examples/{driver_dense, feast_window, chebyshev_window,
spectrum_slicing, state_following_ho, pyrazine_vibronic, mps_sop_lanczos,
ttns_tree_lanczos}.py`` runs its own
``main`` (in a temporary directory, its solver calls recorded), and
``eigensolvers_tpu_torch.examples.<name>.run(device="cpu")`` runs the
same problem from the same seeds.  Tolerance: the levels agree in f64 to
1e-8 relative (the level each example reports: the Ritz values of an
inexact solve that are not converged differ at the inner tolerance); the
iteration counts and ``isConverged`` are equal.
Spectrum slicing runs at n = 48 (the example's n = 400 takes minutes on
one CPU thread): the JAX package's call is made with the example's
arguments at that size.  The tensor-network demos' levels are held at
1e-8 relative and their tree-DMRG energy at 1e-10 (``tests/
test_torch_ttns.py``'s tolerances).  Also here: every example's ``main`` raises
without a card unless given ``--cpu``."""

import importlib
import pkgutil

import numpy as np
import pytest
import torch

import eigensolvers_tpu
from test_torch_common import (one_blas_thread,  # noqa: F401
                               DMRG_RTOL, LANCZOS, TREE_DMRG, nearest,
                               run_jax_example)

import eigensolvers_tpu_torch.examples as examples
from eigensolvers_tpu_torch.examples import (chebyshev_window, driver_dense,
                                             feast_window, mps_sop_lanczos,
                                             pyrazine_vibronic,
                                             spectrum_slicing,
                                             state_following_ho,
                                             ttns_tree_lanczos)

RTOL = 1e-8


pytestmark = pytest.mark.usefixtures("one_blas_thread")


def close(a, b, rtol=RTOL):
    a, b = np.real(np.asarray(a, float)), np.real(np.asarray(b, float))
    assert a.shape == b.shape, (a, b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=0)


def same_counts(st_torch, st_jax, keys):
    for k in keys:
        assert st_torch[k] == st_jax[k], (k, st_torch[k], st_jax[k])


def test_driver_dense_matches_jax(monkeypatch, tmp_path):
    _, calls = run_jax_example(
        monkeypatch, tmp_path, "driver_dense",
        spies=[(eigensolvers_tpu, "inexactLanczosDiagonalization")])
    ev_j, _, st_j = calls["inexactLanczosDiagonalization"][0]
    got = driver_dense.run(device="cpu", out=tmp_path / "torch")
    close(got["nearest"], eigensolvers_tpu.find_nearest(ev_j, 30)[1])
    same_counts(got["status"], st_j, ("cumIter", "isConverged"))
    assert got["status"]["isConverged"]
    assert abs(got["nearest"] - got["exact"]) <= 1e-6 * got["exact"]
    assert (tmp_path / "torch" / "summary_lanczos.out").exists()


def test_feast_window_matches_jax(monkeypatch, tmp_path):
    _, calls = run_jax_example(
        monkeypatch, tmp_path, "feast_window",
        spies=[(eigensolvers_tpu, "feastDiagonalization")])
    ev_j, _, st_j = calls["feastDiagonalization"][0]
    got = feast_window.run(device="cpu", out=tmp_path / "torch")
    want = np.sort(np.real(np.asarray(ev_j)))
    want = want[(want >= 160.0) & (want <= 166.0)]
    # the found value nearest each exact level of the window (an extra
    # in-window Ritz value that is no level differs at the solve
    # tolerance, 1e-2)
    near = [[v[np.argmin(np.abs(v - e))] for e in got["exact"]]
            for v in (got["ev"], want)]
    close(*near)
    close(near[0], got["exact"], rtol=1e-6)
    same_counts(got["status"], st_j, ("outerIter", "isConverged"))


def test_chebyshev_window_matches_jax(monkeypatch, tmp_path):
    _, calls = run_jax_example(
        monkeypatch, tmp_path, "chebyshev_window",
        spies=[(eigensolvers_tpu, "chebyshevFilteredDiagonalization")])
    ev_j, _, st_j = calls["chebyshevFilteredDiagonalization"][0]
    got = chebyshev_window.run(device="cpu", out=tmp_path / "torch")
    want = np.sort(np.real(np.asarray(ev_j)))
    want = want[(want >= 160.0) & (want <= 166.0)]
    close(got["ev"], want)
    close(got["ev"], got["exact"])
    same_counts(got["status"], st_j, ("outerIter", "isConverged", "degree"))


def test_spectrum_slicing_matches_jax():
    n, interval = 48, (30.25, 50.25)
    got = spectrum_slicing.run(device="cpu", n=n, interval=interval)
    from eigensolvers_tpu.models.synthetic import known_spectrum_matrix
    H, ev = known_spectrum_matrix(n, eigenvalues=np.linspace(1, 2 * n, n),
                                  seed=10)
    ev_j, _, st_j = eigensolvers_tpu.spectrumSlicingDiagonalization(
        np.asarray(H), *interval, nc=8, eConv=1e-8, maxit=12, seed=3)
    close(got["ev"], np.asarray(ev_j))
    close(got["ev"], got["exact"])
    st = got["status"]
    same_counts(st, st_j, ("found_total", "dropped_spurious",
                           "isConverged"))
    assert [w["found"] for w in st["windows"]] == \
        [w["found"] for w in st_j["windows"]]
    assert [w["feast_status"]["outerIter"] for w in st["windows"]] == \
        [w["feast_status"]["outerIter"] for w in st_j["windows"]]


def test_state_following_ho_matches_jax(monkeypatch, tmp_path):
    _, calls = run_jax_example(
        monkeypatch, tmp_path, "state_following_ho",
        spies=[(eigensolvers_tpu, "inexactLanczosDiagonalization")])
    ev_j, _, st_j = calls["inexactLanczosDiagonalization"][0]
    got = state_following_ho.run(device="cpu", out=tmp_path / "torch")
    close(got["followed"], np.real(np.asarray(ev_j))[0])
    close(got["followed"], got["exact"])
    same_counts(got["status"], st_j, ("cumIter", "isConverged"))


def test_pyrazine_vibronic_matches_jax(monkeypatch, tmp_path):
    _, calls = run_jax_example(
        monkeypatch, tmp_path, "pyrazine_vibronic",
        spies=[(eigensolvers_tpu, "inexactLanczosDiagonalization")])
    ev_j, _, st_j = calls["inexactLanczosDiagonalization"][0]
    got = pyrazine_vibronic.run(device="cpu", out=tmp_path / "torch")
    want = eigensolvers_tpu.find_nearest(
        np.real(np.asarray(ev_j)), got["exact"])[1]
    close(got["level"], want)
    close(got["level"], got["exact"])
    same_counts(got["status"], st_j, ("cumIter", "isConverged"))


# --------------------------------------------------------------------------
# the tensor-network demos (examples 9, 10)
# --------------------------------------------------------------------------
def test_mps_sop_lanczos_matches_jax(monkeypatch, tmp_path):
    _, calls = run_jax_example(monkeypatch, tmp_path, "mps_sop_lanczos",
                               spies=[LANCZOS])
    ev_j, _, st_j = calls["inexactLanczosDiagonalization"][0]
    got = mps_sop_lanczos.run(device="cpu", out=tmp_path / "torch")
    close(got["level"], nearest(ev_j, got["exact"]))
    close(got["level"], got["exact"])
    assert got["status"]["cumIter"] == st_j["cumIter"]
    assert got["status"]["isConverged"] == st_j["isConverged"]


def test_ttns_tree_lanczos_matches_jax(monkeypatch, tmp_path):
    _, calls = run_jax_example(monkeypatch, tmp_path, "ttns_tree_lanczos",
                               spies=[LANCZOS, TREE_DMRG])
    (ev_k, _, st_k), (ev_a, _, st_a) = calls["inexactLanczosDiagonalization"]
    es_j, _ = calls["tree_dmrg_eigensolve"][0]
    got = ttns_tree_lanczos.run(device="cpu", out=tmp_path / "torch")
    close(got["krylov"], nearest(ev_k, got["exact"]))
    close(got["als"], nearest(ev_a, got["exact"]))
    close(got["dmrg"], es_j[0], DMRG_RTOL)
    for st, sj in ((got["status"], st_k), (got["status_als"], st_a)):
        assert (st["cumIter"], st["isConverged"]) == \
            (sj["cumIter"], sj["isConverged"])


ARGV = {"ch3cn_dmrg_zpve": ["4", "4"]}


@pytest.mark.parametrize("name", sorted(
    m.name for m in pkgutil.iter_modules(examples.__path__)
    if not m.name.startswith("_")))
def test_examples_need_a_card_or_cpu(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"eigensolvers_tpu_torch.examples.{name}")
    assert callable(mod.run)
    with pytest.raises(RuntimeError, match="--cpu"):
        mod.main(ARGV.get(name, []))
