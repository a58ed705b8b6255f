"""The CH3CN tree drivers against their JAX counterparts, at tiny sizes:
the excited ladder (the flagship), the tree ZPVE ladder and tree FEAST.

The JAX side runs ``examples/<name>.py``'s own ``main`` with its command
line and environment, in a temporary directory, with its ``ART``/``LOG``
globals pointed there (nothing reaches the repository's ``artifacts/``)
and its solver calls recorded.  The port's ``run(device="cpu")`` runs the
same problem into its own ``out``.  Tolerances are those
``tests/test_torch_mps.py`` and ``tests/test_torch_ttns.py`` use for the
same quantities: DMRG energies 1e-10 relative, Lanczos and FEAST levels
1e-8 relative (gauge-free: eigenvalues only; 1e-8 of ~1e4 cm-1 is 1e-4
cm-1, the records' rounding); the records carry the same keys and values.
The chain drivers' parity is in ``tests/test_torch_examples_chain.py``.

Also: ``--seed-rung`` gives the next rung of a ladder run from the rung
below; the tree ZPVE ladder's depth-confirm branch raises a clear error
where the JAX driver crashes (ROADMAP C.3); no ported CH3CN driver (nor the
FEAST-filter tool) writes into ``artifacts/``."""

import hashlib
import os

import numpy as np
import pytest

import eigensolvers_tpu
from test_torch_common import (one_blas_thread,  # noqa: F401
                               DMRG_RTOL, FAKE_ZPVE, FEAST, LANCZOS, TINY,
                               TINY_ENV, TREE_DMRG, close, records,
                               run_jax_example, same_record, seed_log)

from eigensolvers_tpu_torch.examples import _common as C
from eigensolvers_tpu_torch.examples import (
    ch3cn_block_lanczos, ch3cn_dmrg_zpve, ch3cn_excited_production,
    ch3cn_feast, ch3cn_feast_production, ch3cn_maxd_ladder,
    ch3cn_production, ch3cn_representation_2mode,
    ch3cn_representation_check, ch3cn_targeted_lanczos,
    ch3cn_tree_production)
from eigensolvers_tpu_torch.models.molecules import ch3cn_tree
from eigensolvers_tpu_torch.tools import diag_feast_filter
from eigensolvers_tpu_torch.vectors.ttns import ttns_embed_physical

CH3CN_DRIVERS = ("ch3cn_excited_production", "ch3cn_tree_production",
                 "ch3cn_feast_production", "ch3cn_dmrg_zpve",
                 "ch3cn_targeted_lanczos", "ch3cn_block_lanczos",
                 "ch3cn_feast", "ch3cn_production", "ch3cn_maxd_ladder",
                 "ch3cn_representation_check", "ch3cn_representation_2mode",
                 "diag_feast_filter")
RAN = set()


pytestmark = pytest.mark.usefixtures("one_blas_thread")


def artifacts_listing():
    h = hashlib.sha256()
    for root, dirs, files in sorted(os.walk(C.ART)):
        dirs.sort()
        for name in sorted(files):
            p = os.path.join(root, name)
            st = os.stat(p)
            h.update(f"{p}|{st.st_size}|{st.st_mtime_ns}\n".encode())
    return h.hexdigest()


@pytest.fixture(scope="module")
def artifacts_before():
    return artifacts_listing()


@pytest.fixture(autouse=True)
def _watch(artifacts_before):
    """Takes the listing of artifacts/ before this file's first run."""


# --------------------------------------------------------------------------
# the excited ladder (example 2): tiny rungs N = 3 -> 4
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def excited(tmp_path_factory):
    """The port's tiny ladder N = 3 -> 4 (maxD 4, L 3, maxit 1), the N = 4
    zpve from a seeded record."""
    out = tmp_path_factory.mktemp("excited_torch")
    seed_log(out, FAKE_ZPVE)
    RAN.add("ch3cn_excited_production")
    return out, ch3cn_excited_production.run(
        [3, 4], nSweep=2, eConv=1e-6, nBlock=2, device="cpu", out=out,
        **TINY)


def test_ch3cn_excited_production_matches_jax(monkeypatch, tmp_path,
                                              excited):
    out, got = excited
    jout = tmp_path / "jax"
    seed_log(jout, FAKE_ZPVE)
    _, calls = run_jax_example(monkeypatch, tmp_path,
                               "ch3cn_excited_production", argv=[3, 4],
                               env=TINY_ENV, out=jout, spies=[TREE_DMRG])
    es_j, _ = calls["tree_dmrg_eigensolve"][0]
    close([e for e in got["rungs"][0]["dmrg_cm1"]],
          [float(eigensolvers_tpu.utils.units.au2unit(e, "cm-1"))
           for e in es_j], DMRG_RTOL)
    want = [r for r in records(jout) if r.get("kind") == "excited"]
    mine = [r["record"] for r in got["rungs"]]
    assert [r["N"] for r in want] == [r["N"] for r in mine] == [3, 4]
    for a, b in zip(mine, want):
        same_record(a, b, cm_keys=("zpve_cm1", "ev_cm1", "excitation_cm1"))
    # the same output files, under the port's --out
    for name in ("ch3cn_tree_excited_N4_b1.npz",
                 "summary_ch3cn_excited_N4.out",
                 "iterations_ch3cn_excited_N3.out"):
        assert (jout / name).exists() and (out / name).exists(), name


def test_excited_seed_rung_gives_the_next_rung(tmp_path, excited):
    """``--seed-rung 3`` from the ladder's N = 3 states gives its N = 4
    rung; and a rerun skips what the output's own log has done."""
    out, got = excited
    seeded = tmp_path / "seeded"
    seed_log(seeded, FAKE_ZPVE)
    res = ch3cn_excited_production.run(
        [4], nSweep=2, eConv=1e-6, nBlock=2, device="cpu", out=seeded,
        seed_rung=3, seed_dir=str(out), **TINY)
    a, b = res["rungs"][0]["record"], got["rungs"][1]["record"]
    same_record(a, b, cm_keys=("zpve_cm1", "ev_cm1", "excitation_cm1"))
    close(np.sort(np.real(res["rungs"][0]["ev"])),
          np.sort(np.real(got["rungs"][1]["ev"])))
    again = ch3cn_excited_production.run([4], device="cpu", out=seeded,
                                         **TINY)
    assert again["rungs"] == []
    with pytest.raises(FileNotFoundError, match="--seed-rung 5"):
        ch3cn_excited_production.run([6], device="cpu", out=tmp_path / "x",
                                     seed_rung=5, seed_dir=str(out), **TINY)


# --------------------------------------------------------------------------
# the tree ZPVE ladder (example 3) and C.3
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    out = tmp_path_factory.mktemp("tree_torch")
    RAN.add("ch3cn_tree_production")
    return out, ch3cn_tree_production.run([6], device="cpu", out=out, **TINY)


def test_ch3cn_tree_production_matches_jax(monkeypatch, tmp_path, tree):
    out, got = tree
    jout = tmp_path / "jax"
    _, calls = run_jax_example(monkeypatch, tmp_path, "ch3cn_tree_production",
                               argv=[6], env=TINY_ENV, out=jout,
                               spies=[TREE_DMRG, LANCZOS])
    es_j, _ = calls["tree_dmrg_eigensolve"][0]
    ev_j, _, st_j = calls["inexactLanczosDiagonalization"][0]
    rung = got["rungs"][0]
    close(rung["ev"], np.asarray(ev_j))
    assert rung["status"]["cumIter"] == st_j["cumIter"]
    [want] = records(jout)
    same_record(rung["record"], want, cm_keys=("zpve_cm1", "err_vs_ref_cm1"))
    assert (out / "ch3cn_tree_state_N6.npz").exists()


def test_tree_depth_confirm_raises_where_jax_crashes(monkeypatch, tmp_path,
                                                     tree):
    """Rungs 6 and 7 done, only N = 7's state on disk, CH3CN_DEPTH_CONFIRM:
    the resume loop leaves the ladder at N = 7 and rung 6 has no state of
    its own.  The JAX driver embeds 7 -> 6 and np.pad fails on a negative
    width; the port says what is missing."""
    out, got = tree
    state6 = C.load_tensors(str(out / "ch3cn_tree_state_N6.npz"))
    parts = ch3cn_tree()[1]
    state7 = ttns_embed_physical(state6, parts, 6, 7, device="cpu")
    rec6 = got["rungs"][0]["record"]
    for d in (tmp_path / "jax", tmp_path / "torch"):
        seed_log(d, rec6, dict(rec6, N=7))
        C.save_tensors(str(d / "ch3cn_tree_state_N7.npz"), state7)
    env = dict(TINY_ENV, CH3CN_DEPTH_CONFIRM=1)
    with pytest.raises(ValueError, match="negative"):
        run_jax_example(monkeypatch, tmp_path, "ch3cn_tree_production",
                        argv=[6, 7], env=env, out=tmp_path / "jax")
    with pytest.raises(ValueError, match="state_N6.npz is missing and the "
                                         "ladder's state is at N=7 > 6"):
        ch3cn_tree_production.run([6, 7], depth_confirm=True, device="cpu",
                                  out=tmp_path / "torch", **TINY)


# --------------------------------------------------------------------------
# tree FEAST (example 11)
# --------------------------------------------------------------------------
FEAST_ENV = {"CH3CN_FEAST_NC": 2, "CH3CN_FEAST_MAXIT": 2,
             "CH3CN_FEAST_NSWEEP": 2, "CH3CN_FEAST_MAXD": 2}


def test_ch3cn_feast_production_matches_jax(monkeypatch, tmp_path):
    jout, out = tmp_path / "jax", tmp_path / "torch"
    for d in (jout, out):
        seed_log(d, FAKE_ZPVE)
    _, calls = run_jax_example(monkeypatch, tmp_path,
                               "ch3cn_feast_production", argv=[4],
                               env=FEAST_ENV, out=jout, spies=[FEAST])
    ev_j, _, st_j = calls["feastDiagonalization"][0]
    RAN.add("ch3cn_feast_production")
    got = ch3cn_feast_production.run(4, maxD=2, nc=2, maxit=2, nSweep=2,
                                     device="cpu", out=out)
    [want] = [r for r in records(jout) if r.get("kind") == "feast_window"]
    same_record(got["record"], want,
                cm_keys=("in_window_cm1", "all_ritz_cm1"))
    assert got["status"]["outerIter"] == st_j["outerIter"]


# --------------------------------------------------------------------------
# outputs, devices
# --------------------------------------------------------------------------
def test_out_may_not_be_artifacts():
    with pytest.raises(ValueError, match="never write into artifacts"):
        C.out_dir(C.ART)


TINY_RUNS = {
    "ch3cn_excited_production": lambda o: (
        seed_log(o, FAKE_ZPVE), ch3cn_excited_production.run(
            [3], device="cpu", out=o, **TINY)),
    "ch3cn_tree_production": lambda o: ch3cn_tree_production.run(
        [6], device="cpu", out=o, **TINY),
    "ch3cn_feast_production": lambda o: (
        seed_log(o, FAKE_ZPVE), ch3cn_feast_production.run(
            4, maxD=2, nc=2, maxit=1, nSweep=2, device="cpu", out=o)),
    "ch3cn_dmrg_zpve": lambda o: ch3cn_dmrg_zpve.run(4, 4, device="cpu"),
    "ch3cn_targeted_lanczos": lambda o: ch3cn_targeted_lanczos.run(
        3, 4, 4, device="cpu", out=o),
    "ch3cn_block_lanczos": lambda o: ch3cn_block_lanczos.run(
        4, 4, 3, 1, device="cpu", out=o),
    "ch3cn_feast": lambda o: ch3cn_feast.run(4, 4, 4, device="cpu", out=o),
    "ch3cn_production": lambda o: ch3cn_production.run(
        [5], device="cpu", out=o, **TINY),
    "ch3cn_maxd_ladder": lambda o: ch3cn_maxd_ladder.run(
        [3], N=4, nSweep=1, device="cpu", out=o),
    "ch3cn_representation_check": lambda o: ch3cn_representation_check.run(
        N=4, maxD=3, nSweep=1, device="cpu", out=o),
    "ch3cn_representation_2mode": lambda o: ch3cn_representation_2mode.run(
        oracle_N=6, Ns=(4,), mode_cuts=(3,), N_dmrg=4, maxD=4, nSweep=1,
        device="cpu", out=o),
    "diag_feast_filter": lambda o: diag_feast_filter.run(3, device="cpu"),
}


def test_no_ported_driver_writes_into_artifacts(tmp_path, artifacts_before):
    """The listing and mtimes of ``artifacts/`` are what they were before
    this file's runs of every CH3CN driver (those not run by an earlier
    test here run now)."""
    assert set(TINY_RUNS) == set(CH3CN_DRIVERS)
    for name in CH3CN_DRIVERS:
        if name not in RAN:
            TINY_RUNS[name](tmp_path / name)
            RAN.add(name)
    assert artifacts_listing() == artifacts_before
