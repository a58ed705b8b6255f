"""The CH3CN chain (MPS) drivers against their JAX counterparts, at tiny
sizes: ``examples/{ch3cn_dmrg_zpve, ch3cn_targeted_lanczos,
ch3cn_block_lanczos, ch3cn_feast, ch3cn_production}.py``.

The JAX side runs its own ``main`` with its command line and environment
in a temporary directory (``ART``/``LOG`` pointed there), its solver calls
recorded; the port's ``run(device="cpu")`` runs the same problem into its
own ``out``.  Tolerances (``tests/test_torch_mps.py``'s for the same
quantities): DMRG energies 1e-10 relative, Lanczos and FEAST levels 1e-8
relative (eigenvalues only: the gauges differ; the block example's pair,
whose ALS solves stop at convTol 5e-2, 1e-7); records with the same keys
and values (cm-1 values to the records' 1e-4 rounding); the same
checkpoint files."""

import os

import numpy as np
import pytest

import eigensolvers_tpu
from test_torch_common import (one_blas_thread,  # noqa: F401
                               DMRG, FEAST, LANCZOS, TINY, TINY_ENV,
                               DMRG_RTOL, close, nearest, records,
                               run_jax_example, same_record)

from eigensolvers_tpu_torch.examples import (
    ch3cn_block_lanczos, ch3cn_dmrg_zpve, ch3cn_feast, ch3cn_production,
    ch3cn_targeted_lanczos)


pytestmark = pytest.mark.usefixtures("one_blas_thread")


def test_ch3cn_dmrg_zpve_matches_jax(monkeypatch, tmp_path):
    _, calls = run_jax_example(monkeypatch, tmp_path, "ch3cn_dmrg_zpve",
                               argv=[4, 4], spies=[DMRG])
    es_j, _ = calls["dmrg_eigensolve"][0]
    got = ch3cn_dmrg_zpve.run(4, 4, device="cpu")
    close(got["zpve_cm1"],
          eigensolvers_tpu.utils.units.au2unit(es_j[0], "cm-1"), DMRG_RTOL)


def test_ch3cn_targeted_lanczos_matches_jax(monkeypatch, tmp_path):
    _, calls = run_jax_example(monkeypatch, tmp_path,
                               "ch3cn_targeted_lanczos", argv=[3, 4, 4],
                               spies=[DMRG, LANCZOS])
    es_j, _ = calls["dmrg_eigensolve"][0]
    ev_j, _, st_j = calls["inexactLanczosDiagonalization"][0]
    got = ch3cn_targeted_lanczos.run(3, 4, 4, device="cpu",
                                     out=tmp_path / "torch")
    au2unit = eigensolvers_tpu.utils.units.au2unit
    close(got["guess_cm1"], au2unit(es_j[0], "cm-1"), DMRG_RTOL)
    close(got["zpve_cm1"],
          au2unit(nearest(ev_j, float(es_j[0])), "cm-1"))
    assert got["status"]["cumIter"] == st_j["cumIter"]


def test_ch3cn_block_lanczos_matches_jax(monkeypatch, tmp_path):
    _, calls = run_jax_example(monkeypatch, tmp_path, "ch3cn_block_lanczos",
                               argv=[4, 4, 4, 2], spies=[DMRG, LANCZOS])
    es_j, _ = calls["dmrg_eigensolve"][0]
    ev_j, _, st_j = calls["inexactLanczosDiagonalization"][0]
    got = ch3cn_block_lanczos.run(4, 4, 4, 2, device="cpu",
                                  out=tmp_path / "torch")
    au2unit = eigensolvers_tpu.utils.units.au2unit
    close(got["dmrg_cm1"], [au2unit(e, "cm-1") for e in es_j], DMRG_RTOL)
    # the two levels nearest sigma (the block's)
    sigma = float(es_j[0]) + float(
        eigensolvers_tpu.utils.units.unit2au(360.0, "cm-1"))
    def pick(ev):
        ev = np.real(np.asarray(ev))
        return np.sort(ev[np.argsort(np.abs(ev - sigma))[:2]])
    # the example's own solves stop at convTol 5e-2 (eConv 1e-6): the
    # pair agrees to 2.4e-8 relative, so this one is held at 1e-7
    close(pick(got["ev"]), pick(ev_j), 1e-7)
    assert got["status"]["isConverged"]
    assert (got["status"]["cumIter"], got["status"]["isConverged"]) == \
        (st_j["cumIter"], st_j["isConverged"])
    assert sorted(os.listdir(got["checkpoint"])) == \
        sorted(os.listdir(tmp_path / "finalLanczosMPSs"))


def test_ch3cn_feast_matches_jax(monkeypatch, tmp_path):
    _, calls = run_jax_example(monkeypatch, tmp_path, "ch3cn_feast",
                               argv=[4, 4, 4], spies=[DMRG, FEAST])
    es_j, _ = calls["dmrg_eigensolve"][0]
    ev_j, _, st_j = calls["feastDiagonalization"][0]
    got = ch3cn_feast.run(4, 4, 4, device="cpu", out=tmp_path / "torch")
    au2unit = eigensolvers_tpu.utils.units.au2unit
    close(got["dmrg_cm1"], [au2unit(e - es_j[0], "cm-1") for e in es_j],
          1e-8)
    ev = np.sort(np.real(np.asarray(ev_j)))
    want = [float(au2unit(e - es_j[0], "cm-1")) for e in ev]
    lo, hi = got["window_cm1"]
    want = [w for w in want if lo <= w <= hi]
    close(got["found_cm1"], want)
    assert got["status"]["outerIter"] == st_j["outerIter"]


def test_ch3cn_production_matches_jax(monkeypatch, tmp_path):
    jout = tmp_path / "jax"
    _, calls = run_jax_example(monkeypatch, tmp_path, "ch3cn_production",
                               argv=[5], env=TINY_ENV, out=jout,
                               spies=[DMRG, LANCZOS])
    ev_j, _, st_j = calls["inexactLanczosDiagonalization"][0]
    out = tmp_path / "torch"
    got = ch3cn_production.run([5], device="cpu", out=out, **TINY)
    rung = got["rungs"][0]
    sigma = float(calls["dmrg_eigensolve"][0][0][0])
    close(nearest(rung["ev"], sigma), nearest(ev_j, sigma))
    [want] = records(jout)
    same_record(rung["record"], want, cm_keys=("zpve_cm1", "err_vs_ref_cm1"))
    assert rung["status"]["cumIter"] == st_j["cumIter"]
    assert sorted(os.listdir(out / "ch3cn_ckpt_N5")) == \
        sorted(os.listdir(jout / "ch3cn_ckpt_N5"))
