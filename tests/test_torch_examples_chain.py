"""The CH3CN chain (MPS) drivers and the FEAST-filter tool against their
JAX counterparts, at tiny sizes: ``examples/{ch3cn_dmrg_zpve,
ch3cn_targeted_lanczos, ch3cn_block_lanczos, ch3cn_feast,
ch3cn_production, ch3cn_maxd_ladder, ch3cn_representation_check,
ch3cn_representation_2mode}.py`` and ``tools/diag_feast_filter.py``.

The JAX side runs its own ``main`` with its command line and environment
in a temporary directory (``ART``/``LOG`` pointed there), its solver calls
recorded; the port's ``run(device="cpu")`` runs the same problem into its
own ``out``.  Tolerances (``tests/test_torch_mps.py``'s for the same
quantities): DMRG energies 1e-10 relative, Lanczos and FEAST levels 1e-8
relative (eigenvalues only: the gauges differ; the block example's pair,
whose ALS solves stop at convTol 5e-2, 1e-7); records with the same keys
and values (cm-1 values to the records' 1e-4 rounding); the same
checkpoint files.

The maxD ladder's JAX run has its ``ART`` pointed at a temporary directory,
so it seeds randomly, as the port does where no committed state exists.
The 2-mode study's JAX ``main`` is fixed at the production sizes, so its
test makes that ``main``'s JAX package calls in the same order at a small
size: dense eigenvalues 1e-10 relative, its DMRG rows 1e-10, its record's
values to their rounding.  The diagnosis tool: residuals, filtered
Rayleigh quotients and norms 1e-8 relative."""

import importlib.util
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

import eigensolvers_tpu
from test_torch_common import (one_blas_thread,  # noqa: F401
                               DMRG, FEAST, LANCZOS, TINY, TINY_ENV,
                               DMRG_RTOL, close, jax_example, nearest,
                               records, run_jax_example, same_record)

from eigensolvers_tpu_torch.examples import (
    ch3cn_block_lanczos, ch3cn_dmrg_zpve, ch3cn_feast, ch3cn_maxd_ladder,
    ch3cn_production, ch3cn_representation_2mode,
    ch3cn_representation_check, ch3cn_targeted_lanczos)
from eigensolvers_tpu_torch.tools import diag_feast_filter


pytestmark = pytest.mark.usefixtures("one_blas_thread")

au2unit = eigensolvers_tpu.utils.units.au2unit
LADDER_ENV = {"CH3CN_N": 4, "CH3CN_SWEEPS": 2}
ZPVE_KEYS = ("zpve_cm1", "err_vs_ref_cm1")


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


# --------------------------------------------------------------------------
# the maxD ladder
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ladder(tmp_path_factory):
    """The port's tiny ladder: N = 4, maxD 3 -> 4, two sweeps a rung."""
    out = tmp_path_factory.mktemp("ladder_torch")
    return out, ch3cn_maxd_ladder.run([3, 4], N=4, nSweep=2, device="cpu",
                                      out=out)


def test_ch3cn_maxd_ladder_matches_jax(monkeypatch, tmp_path, ladder):
    out, got = ladder
    jout = tmp_path / "jax"
    _, calls = run_jax_example(monkeypatch, tmp_path, "ch3cn_maxd_ladder",
                               argv=[3, 4], env=LADDER_ENV, out=jout,
                               spies=[DMRG])
    assert got["seed"] is None
    close([r["zpve_cm1"] for r in got["rungs"]],
          [au2unit(es[0], "cm-1") for es, _ in calls["dmrg_eigensolve"]],
          DMRG_RTOL)
    want = records(jout)
    assert [r["maxD"] for r in want] == [3, 4]
    for mine, theirs in zip([r["record"] for r in got["rungs"]], want):
        same_record(mine, theirs, cm_keys=ZPVE_KEYS)
    assert sorted(p.name for p in out.glob("*.npz")) == \
        sorted(p.name for p in jout.glob("*.npz")) == \
        ["ch3cn_state_N4_D3.npz", "ch3cn_state_N4_D4.npz"]


def test_seed_maxd_gives_the_next_rung(monkeypatch, tmp_path, ladder):
    """``--seed-maxd 3`` from the ladder's maxD 3 state gives its maxD 4
    rung; a rerun skips what the output's own log has done; a missing seed
    state is named."""
    out, got = ladder
    seeded = tmp_path / "seeded"
    res = ch3cn_maxd_ladder.run([4], N=4, nSweep=2, device="cpu",
                                out=seeded, seed_maxd=3, seed_dir=str(out))
    assert res["seed"] == str(out / "ch3cn_state_N4_D3.npz")
    [rung] = res["rungs"]
    same_record(rung["record"], got["rungs"][1]["record"])
    close(rung["zpve_cm1"], got["rungs"][1]["zpve_cm1"], DMRG_RTOL)
    for k, v in LADDER_ENV.items():
        monkeypatch.setenv(k, str(v))
    again = ch3cn_maxd_ladder.main(["4", "--cpu", "--out", str(seeded)])
    assert again == 0 and len(records(seeded)) == 1
    with pytest.raises(FileNotFoundError, match="--seed-maxd 5"):
        ch3cn_maxd_ladder.run([6], N=4, device="cpu", out=tmp_path / "x",
                              seed_maxd=5, seed_dir=str(out))


# --------------------------------------------------------------------------
# the representation check, both representations
# --------------------------------------------------------------------------
@pytest.mark.parametrize("rep", ["dvr", "fbr"])
def test_ch3cn_representation_check_matches_jax(monkeypatch, tmp_path, rep):
    jout = tmp_path / "jax"
    jout.mkdir()                  # the JAX script writes into ART as it is
    env = {"CH3CN_N": 4, "CH3CN_MAXD": 3, "CH3CN_REP": rep}
    _, calls = run_jax_example(monkeypatch, tmp_path,
                               "ch3cn_representation_check", env=env,
                               out=jout, spies=[DMRG])
    got = ch3cn_representation_check.run(N=4, maxD=3, rep=rep, device="cpu",
                                         out=tmp_path / "torch")
    [(es_j, _)] = calls["dmrg_eigensolve"]
    close(got["zpve_cm1"], au2unit(es_j[0], "cm-1"), DMRG_RTOL)
    assert not got["seeded"]
    [want] = records(jout)
    same_record(got["record"], want, cm_keys=ZPVE_KEYS)
    assert records(tmp_path / "torch") == [got["record"]]


# --------------------------------------------------------------------------
# the 2-mode study
# --------------------------------------------------------------------------
ORACLE_N, NS, CUTS, N_DMRG, MAXD_2M = 10, (4, 6), (3,), 5, 8


def jax_2mode(mod):
    """``examples/ch3cn_representation_2mode.py::main``'s calls and record
    at the small size: (record, oracle zpve, {(k, rep): DMRG zpve})."""
    from eigensolvers_tpu.models.molecules import ch3cn_operator
    from eigensolvers_tpu.vectors.mps import MPO
    from eigensolvers_tpu.vectors.mps_sweeps import dmrg_eigensolve

    e_oracle = float(np.linalg.eigvalsh(mod.two_mode_dense(ORACLE_N,
                                                           "fbr"))[0])
    zpve_oracle = float(au2unit(e_oracle, "cm-1"))
    rows = []
    for rep in ("fbr", "dvr"):
        for N in NS:
            evs = np.linalg.eigvalsh(mod.two_mode_dense(N, rep))
            k = int(np.argmin(np.abs(evs - e_oracle)))
            zpve = float(au2unit(float(evs[k]), "cm-1"))
            rows.append({"representation": rep, "N": N,
                         "zpve_cm1": round(zpve, 6),
                         "err_vs_oracle_cm1": round(zpve - zpve_oracle, 6),
                         "lowest_state_cm1": round(float(
                             au2unit(float(evs[0]), "cm-1")), 4),
                         "n_collapsed_below": k})
    zps = {}
    for k in CUTS:
        for rep in ("fbr", "dvr"):
            op, _, _ = ch3cn_operator(N=N_DMRG, nModesCut=k,
                                      representation=rep)
            mpo = MPO.from_sop_compressed(op)
            es, _ = dmrg_eigensolve(mpo.tensors, [N_DMRG] * k, nStates=1,
                                    maxD=MAXD_2M, nSweep=6, convTol=1e-12,
                                    seed=1)
            zps[k, rep] = float(au2unit(float(es[0]), "cm-1"))
        rows.append({"representation": "dvr-vs-fbr", "nModes": k,
                     "N": N_DMRG,
                     "zpve_fbr_cm1": round(zps[k, "fbr"], 6),
                     "zpve_dvr_cm1": round(zps[k, "dvr"], 6),
                     "dvr_minus_fbr_cm1": round(zps[k, "dvr"]
                                                - zps[k, "fbr"], 6)})
    rec = {"kind": "representation_2mode",
           f"oracle_fbr_N{ORACLE_N}_cm1": round(zpve_oracle, 6),
           "rows": rows}
    return rec, zpve_oracle, zps


def test_ch3cn_representation_2mode_matches_jax(tmp_path):
    mod = jax_example("ch3cn_representation_2mode")
    for N in (6, ORACLE_N):
        for rep in ("fbr", "dvr"):
            want = np.linalg.eigvalsh(mod.two_mode_dense(N, rep))
            mine = torch.linalg.eigvalsh(
                ch3cn_representation_2mode.two_mode_dense(N, rep, "cpu"))
            close(mine.numpy(), want, 1e-10)
    rec_j, oracle_j, zps_j = jax_2mode(mod)
    got = ch3cn_representation_2mode.run(
        oracle_N=ORACLE_N, Ns=NS, mode_cuts=CUTS, N_dmrg=N_DMRG,
        maxD=MAXD_2M, device="cpu", out=tmp_path)
    close(got["oracle_cm1"], oracle_j, 1e-10)
    close([got["dmrg_cm1"][k] for k in sorted(zps_j)],
          [zps_j[k] for k in sorted(zps_j)], DMRG_RTOL)
    assert records(tmp_path) == [got["record"]]
    rec = got["record"]
    assert sorted(rec) == sorted(rec_j)
    assert rec[f"oracle_fbr_N{ORACLE_N}_cm1"] == pytest.approx(
        rec_j[f"oracle_fbr_N{ORACLE_N}_cm1"], abs=1.5e-6)
    assert len(rec["rows"]) == len(rec_j["rows"])
    for a, b in zip(rec["rows"], rec_j["rows"]):
        assert sorted(a) == sorted(b)
        for k, v in b.items():
            if isinstance(v, float):
                # rounded cm-1 values: one unit of the 6th decimal
                np.testing.assert_allclose(a[k], v, rtol=0, atol=1.5e-6,
                                           err_msg=k)
            else:
                assert a[k] == v, (k, a[k], v)


# --------------------------------------------------------------------------
# the FEAST filter diagnosis
# --------------------------------------------------------------------------
TOOL = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
    "diag_feast_filter.py"


def test_diag_feast_filter_matches_jax(monkeypatch):
    """The JAX tool at N = 3; its solves, residual combinations and matrix
    representations recorded to rebuild the numbers it prints."""
    from eigensolvers_tpu.vectors.ttns import TTNSVector
    seen = {"solve": [], "linearCombination": [], "matrixRepresentation": []}
    for name in seen:
        fn = getattr(TTNSVector, name)

        def wrapped(cls, *a, _fn=fn, _seen=seen[name], **k):
            res = _fn(*a, **k)
            _seen.append((a, res))
            return res
        monkeypatch.setattr(TTNSVector, name, classmethod(wrapped))
    spec = importlib.util.spec_from_file_location("jax_diag_feast", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["diag_feast_filter.py", "3"])
    mod.main()
    got = diag_feast_filter.run(3, device="cpu")
    assert [r["name"] for r in got["rows"]] == \
        ["random", "bright x11=1", "bright x12=1"]
    assert len(seen["solve"]) == len(seen["linearCombination"]) == 3
    assert len(seen["matrixRepresentation"]) == 6
    for i, row in enumerate(got["rows"]):
        (_, y, z), x = seen["solve"][i]
        assert z == got["z"]
        r = seen["linearCombination"][i][1]
        nx = float(x.norm())
        rq0 = seen["matrixRepresentation"][2 * i][1][0, 0]
        rqx = seen["matrixRepresentation"][2 * i + 1][1][0, 0] / nx ** 2
        close(row["guess_rq_cm1"], au2unit(np.real(rq0), "cm-1"), 1e-10)
        close(row["rel_res"], float(r.norm() / y.norm()), 1e-8)
        close(row["norm_x"], nx, 1e-8)
        close(row["filtered_rq_cm1"], au2unit(np.real(rqx), "cm-1"), 1e-8)
        assert np.isfinite([row["rel_res"], row["filtered_rq_cm1"]]).all()


def test_diag_feast_filter_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        diag_feast_filter.main(["3"])
