"""Shared helpers of the torch port's parity tests (imported by the other
``test_torch_*`` files), and parity tests of the modules the port copied
from the JAX package (config, units, subspace, checkpointing).

Every parity test makes its inputs with numpy from a seed and hands the
same numbers to both packages; operators cross through
``eigensolvers_tpu_torch.convert.operator_from_arrays`` and vectors through
the state-dict round trip.
"""

import importlib.util
import json
import os
import pathlib
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import eigensolvers_tpu
from eigensolvers_tpu import JaxVector
from eigensolvers_tpu.utils import checkpointing as jax_ckpt
from eigensolvers_tpu.utils import subspace as jax_subspace
from eigensolvers_tpu.vectors import mps_sweeps as jax_mps_sweeps
from eigensolvers_tpu.vectors import ttns_sweeps as jax_ttns_sweeps

from eigensolvers_tpu_torch import TorchVector
from eigensolvers_tpu_torch.config import FeastConfig
from eigensolvers_tpu_torch.convert import operator_from_arrays
from eigensolvers_tpu_torch.examples import _common as EXC
from eigensolvers_tpu_torch.ops.operators import resolve_precision
from eigensolvers_tpu_torch.utils import checkpointing as torch_ckpt
from eigensolvers_tpu_torch.utils import subspace as torch_subspace
from eigensolvers_tpu_torch.utils import units as torch_units

# tier-1 runs six xdist workers: one intra-op thread each
torch.set_num_threads(1)

CPU = torch.device("cpu")


def banded(n, bw=3, seed=0):
    """Symmetric banded matrix (tests/test_sparse.py::_banded)."""
    rng = np.random.RandomState(seed)
    d = [rng.rand(n - abs(k)) for k in range(-bw, bw + 1)]
    H = sp.diags(d, offsets=range(-bw, bw + 1)).toarray()
    return (H + H.T) / 2


def dd_matrix(n, seed=3, dominance=2.5):
    """Diagonally dominant symmetric matrix with spread-out diagonal
    (tests/test_preconditioner.py::_dd_matrix)."""
    rng = np.random.RandomState(seed)
    A = rng.rand(n, n) - 0.5
    A = (A + A.T) / 2
    A[np.diag_indices(n)] = np.linspace(1.0, 50.0, n) * dominance
    return A


def torch_op(jop, device=CPU):
    """The port's operator carrying a JAX operator's arrays as stored."""
    if hasattr(jop, "dataT"):
        arrays = {"dataT": np.asarray(jop.dataT), "idx": np.asarray(jop.idx),
                  "n": jop.n, "precision": jop.precision}
    else:
        arrays = {"mat": np.asarray(jop.mat), "precision": jop.precision}
    return operator_from_arrays(arrays, device)


def torch_vec(jv, options=None, device=CPU):
    """The port's vector from a JaxVector's state dict."""
    return TorchVector.from_state_dict(jv.to_state_dict(), options,
                                       device=device)


def as_np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# ---------------------------------------------------------------------------
# copied modules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["default", "high", "highest"])
def test_resolve_precision_accepts_names_and_jax_values(name):
    assert resolve_precision(name) == name
    assert resolve_precision(name.upper()) == name
    assert resolve_precision(getattr(jax.lax.Precision, name.upper())) == name


def test_resolve_precision_rejects_unknown():
    assert resolve_precision(None) == "default"
    with pytest.raises(ValueError, match="precision"):
        resolve_precision("tf32")


def test_feast_config_run_names_its_roadmap_item(monkeypatch):
    """FeastConfig.run (once a ROADMAP item) drives feastDiagonalization
    with its fields."""
    from eigensolvers_tpu_torch.solvers import feast
    seen = {}
    monkeypatch.setattr(feast, "feastDiagonalization",
                        lambda *a, **k: seen.update(args=a, kw=k) or "ran")
    cfg = FeastConfig(nc=6, eMin=-1.0, eMax=2.0, maxit=3, writeOut=False)
    assert cfg.run("A", ["Y"], status={"s": 1}) == "ran"
    assert seen["args"] == ("A", ["Y"], 6, "legendre", -1.0, 2.0, 1e-6, 3)
    assert seen["kw"]["status"] == {"s": 1}
    assert seen["kw"]["writeOut"] is False
    assert seen["kw"]["batchQuadratureSolves"] is True


def test_units_match_reference():
    from eigensolvers_tpu.utils import units as jax_units
    for unit in ("cm-1", "ev", "k", "nm"):
        np.testing.assert_array_equal(torch_units.au2unit(0.25, unit),
                                      jax_units.au2unit(0.25, unit))
        np.testing.assert_array_equal(torch_units.unit2au(3.0, unit),
                                      jax_units.unit2au(3.0, unit))


@pytest.mark.parametrize("seed", [0, 1])
def test_subspace_numerics_match_reference(seed):
    """Löwdin orthogonalization, projected diagonalization and the pick
    functions give the JAX package's numbers on the same matrices."""
    rng = np.random.RandomState(seed)
    A = rng.standard_normal((6, 6))
    S = A @ A.T + 1e-3 * np.eye(6)
    Hm = rng.standard_normal((6, 6))
    Hm = Hm + Hm.T
    ia, _, Xa = torch_subspace.lowdinOrtho(S)
    ib, _, Xb = jax_subspace.lowdinOrtho(S)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_allclose(Xa, Xb, rtol=1e-12)
    ea, _ = torch_subspace.diagonalizeHamiltonian(Xa, Hm)
    eb, _ = jax_subspace.diagonalizeHamiltonian(Xb, Hm)
    np.testing.assert_allclose(ea, eb, rtol=1e-12)
    np.testing.assert_array_equal(
        torch_subspace.get_pick_function_close_to_sigma(0.3)(None, None, ea),
        jax_subspace.get_pick_function_close_to_sigma(0.3)(None, None, eb))
    assert torch_subspace.eigenvalueResidual(ea, eb + 1e-3) == \
        jax_subspace.eigenvalueResidual(ea, eb + 1e-3)


def test_checkpoints_cross_between_packages(tmp_path):
    """A basis saved by either package loads into the other."""
    rng = np.random.RandomState(4)
    arrays = [rng.standard_normal(40) for _ in range(3)]
    status = {"cumIter": 3, "ev": np.arange(3.0)}
    torch_ckpt.save_checkpoint(str(tmp_path / "t"), 3,
                               [TorchVector(a, device=CPU) for a in arrays],
                               status,
                               eigenvalues=np.arange(3.0))
    jvs, jmeta = jax_ckpt.load_checkpoint(str(tmp_path / "t"), 3, JaxVector)
    jax_ckpt.save_checkpoint(str(tmp_path / "j"), 5,
                             [JaxVector(a) for a in arrays], status)
    tvs, tmeta = torch_ckpt.load_checkpoint(str(tmp_path / "j"), 5,
                                            TorchVector, device=CPU)
    for a, jv, tv in zip(arrays, jvs, tvs):
        np.testing.assert_array_equal(np.asarray(jv.array), a)
        np.testing.assert_array_equal(as_np(tv.array), a)
    assert jmeta["status"] == tmeta["status"]
    assert torch_ckpt.latest_tag(str(tmp_path / "j")) == 5
    writer = torch_ckpt.default_async_writer()
    assert writer is not None and writer.available


# --------------------------------------------------------------------------
# the example drivers (tests/test_torch_examples*.py)
# --------------------------------------------------------------------------
EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(scope="module")
def one_blas_thread():
    """One BLAS thread while a test module runs: the sweeps' many small host
    solves (scipy over OpenBLAS, 8 threads by default) spin against the
    other test workers and run 10-40x slower under the six-worker suite."""
    from threadpoolctl import threadpool_limits
    with threadpool_limits(1):
        yield


def jax_example(name):
    """The JAX package's ``examples/<name>.py`` as a fresh module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax_example(monkeypatch, tmp_path, name, argv=(), spies=(),
                    env=None, out=None):
    """Run a JAX example's ``main`` with ``argv`` and ``env`` in
    ``tmp_path``.  ``spies``: (module, attribute) pairs whose functions
    are wrapped to record each call's return value (the example imports
    them inside ``main``, so it picks the wrappers up).  ``out``: a
    directory its ``ART``/``LOG`` globals are pointed at, so nothing
    reaches the repository's ``artifacts/``.  Returns (module, {attribute:
    [results]})."""
    mod = jax_example(name)
    if out is not None:
        monkeypatch.setattr(mod, "ART", str(out))
        monkeypatch.setattr(mod, "LOG",
                            os.path.join(str(out), "ch3cn_production.jsonl"))
    calls = {}
    for owner, attr in spies:
        fn = getattr(owner, attr)
        seen = calls.setdefault(attr, [])

        def wrapped(*a, _fn=fn, _seen=seen, **k):
            res = _fn(*a, **k)
            _seen.append(res)
            return res
        monkeypatch.setattr(owner, attr, wrapped)
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, str(v))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + [str(a) for a in argv])
    assert mod.main() == 0
    return mod, calls


LANCZOS = eigensolvers_tpu, "inexactLanczosDiagonalization"
FEAST = eigensolvers_tpu, "feastDiagonalization"
DMRG = jax_mps_sweeps, "dmrg_eigensolve"
TREE_DMRG = jax_ttns_sweeps, "tree_dmrg_eigensolve"
EV_RTOL, DMRG_RTOL, REC_CM = 1e-8, 1e-10, 1.5e-4
# the tiny ladders: maxD 4, L 3, maxit 1
TINY = dict(maxD=4, L=3, maxit=1)
TINY_ENV = {"CH3CN_MAXD": 4, "CH3CN_L": 3, "CH3CN_MAXIT": 1}
# a tree zpve record for the rungs that have none (both packages read it)
FAKE_ZPVE = {"N": 4, "topology": "tree", "zpve_cm1": 9836.5}


def close(a, b, rtol=EV_RTOL):
    np.testing.assert_allclose(np.real(np.asarray(a, complex)),
                               np.real(np.asarray(b, complex)),
                               rtol=rtol, atol=0)


def nearest(ev, x):
    ev = np.real(np.asarray(ev))
    return float(ev[np.argmin(np.abs(ev - x))])


def same_record(got, want, cm_keys=()):
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for k, v in want.items():
        if k == "wall_s":
            continue
        if k in cm_keys or k == "residual":
            tol = REC_CM if k != "residual" else 1e-3 * abs(v) + 1e-12
            np.testing.assert_allclose(got[k], v, rtol=0, atol=tol, err_msg=k)
        else:
            assert got[k] == v, (k, got[k], v)


def records(d):
    return EXC.read_records(os.path.join(str(d), EXC.LOG_NAME))


def seed_log(d, *recs):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(str(d), EXC.LOG_NAME), "a") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
