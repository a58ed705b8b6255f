"""TorchVector against JaxVector on the same vectors (state-dict round
trip) and the same operators (``operator_from_arrays``).

Tolerance: f64 throughout; the two differ only in summation order, so the
subspace matrices agree to 1e-12 relative to their largest entry."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from eigensolvers_tpu import JaxVector
from eigensolvers_tpu.ops.operators import DenseOperator as JaxDense
from eigensolvers_tpu.ops.sparse import BSROperator as JaxBSR

from eigensolvers_tpu_torch import TorchVector
from eigensolvers_tpu_torch.models import product
from eigensolvers_tpu_torch.ops.operators import (DenseOperator,
                                                  DiagonalOperator,
                                                  as_operator)
from eigensolvers_tpu_torch.ops.sparse import BandedOperator, BSROperator
from test_torch_common import (CPU, as_np, banded, dd_matrix, torch_op,
                               torch_vec)

TOL = 1e-12


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL * max(1.0, np.abs(b).max()))


def _pairs(m, n=96, seed=0, orthonormal=False):
    rng = np.random.RandomState(seed)
    V = rng.standard_normal((m, n))
    if orthonormal:
        V = np.linalg.qr(V.T)[0].T
    jv = [JaxVector(v) for v in V]
    return jv, [torch_vec(v) for v in jv]


def _ops(n=96):
    H = banded(n, bw=5, seed=1)
    jb = JaxBSR.from_dense(H, block_size=32, use_pallas=False)
    jd = JaxDense(dd_matrix(n))
    return [(jb, torch_op(jb)), (jd, torch_op(jd))]


def test_state_dict_round_trip_both_ways():
    jv, tv = _pairs(1)
    np.testing.assert_array_equal(as_np(tv[0].array), np.asarray(jv[0].array))
    back = JaxVector.from_state_dict(tv[0].to_state_dict())
    np.testing.assert_array_equal(np.asarray(back.array),
                                  np.asarray(jv[0].array))
    with pytest.raises(ValueError, match="dense"):
        TorchVector.from_state_dict({"kind": np.asarray("mps"),
                                     "array": np.zeros(3)}, device="cpu")


def test_norm_vdot_normalize():
    jv, tv = _pairs(2)
    assert tv[0].norm() == pytest.approx(jv[0].norm(), rel=TOL)
    for conj in (True, False):
        assert tv[0].vdot(tv[1], conj) == pytest.approx(
            jv[0].vdot(jv[1], conj), rel=TOL)
    _close(as_np(tv[0].copy().normalize().array),
           np.asarray(jv[0].copy().normalize().array))
    assert isinstance(tv[0].vdot(tv[1]), float)


def test_overlap_and_extend_overlap():
    jv, tv = _pairs(5, seed=2)
    _close(TorchVector.overlapMatrix(tv), JaxVector.overlapMatrix(jv))
    S4 = JaxVector.overlapMatrix(jv[:4])
    _close(TorchVector.extendOverlapMatrix(tv, S4),
           JaxVector.extendOverlapMatrix(jv, S4))


@pytest.mark.parametrize("which", [0, 1], ids=["bsr", "dense"])
def test_matrix_representation_and_extend(which):
    jop, top = _ops()[which]
    jv, tv = _pairs(5, seed=3)
    _close(TorchVector.matrixRepresentation(top, tv),
           JaxVector.matrixRepresentation(jop, jv))
    H4 = JaxVector.matrixRepresentation(jop, jv[:4])
    _close(TorchVector.extendMatrixRepresentation(top, tv, H4),
           JaxVector.extendMatrixRepresentation(jop, jv, H4))
    _close(as_np(tv[0].applyOp(top).array), np.asarray(jv[0].applyOp(jop).array))


def test_orthogonalize_against_set_and_lindep():
    jq, tq = _pairs(4, seed=4, orthonormal=True)
    jx, tx = _pairs(1, seed=5)
    jo = JaxVector.orthogonalize_against_set(jx[0], jq)
    to = TorchVector.orthogonalize_against_set(tx[0], tq)
    _close(as_np(to.array), np.asarray(jo.array))
    # a vector inside the span is linearly dependent: both return None
    inside = TorchVector.linearCombination(tq, [0.3, -1.0, 0.5, 2.0])
    j_inside = JaxVector.linearCombination(jq, [0.3, -1.0, 0.5, 2.0])
    assert TorchVector.orthogonalize_against_set(inside, tq) is None
    assert JaxVector.orthogonalize_against_set(j_inside, jq) is None


def test_orthogonalize_drops_dependent_direction():
    jv, tv = _pairs(3, seed=6)
    tv.append(TorchVector.linearCombination(tv, [1.0, 2.0, -1.0]))
    jv.append(JaxVector.linearCombination(jv, [1.0, 2.0, -1.0]))
    to = TorchVector.orthogonalize(tv)
    jo = JaxVector.orthogonalize(jv)
    assert len(to) == len(jo) == 3
    _close(TorchVector.overlapMatrix(to), np.eye(3))
    # same span: the projector onto it agrees
    Pt = sum(np.outer(as_np(v.array), as_np(v.array)) for v in to)
    Pj = sum(np.outer(np.asarray(v.array), np.asarray(v.array)) for v in jo)
    _close(Pt, Pj)


def test_linear_combinations():
    jv, tv = _pairs(4, seed=7)
    c = np.random.RandomState(8).standard_normal(4)
    _close(as_np(TorchVector.linearCombination(tv, c).array),
           np.asarray(JaxVector.linearCombination(jv, c).array))
    C = np.random.RandomState(9).standard_normal((4, 3))
    for t, j in zip(TorchVector.linearCombinationBatch(tv, C),
                    JaxVector.linearCombinationBatch(jv, C)):
        _close(as_np(t.array), np.asarray(j.array))


@pytest.mark.parametrize("precond", [None, "jacobi"])
def test_solve_matches_jax_and_reports(precond):
    jop, top = _ops()[1]
    report = {}
    opts = {"linearSystemArgs": {"linear_tol": 1e-10, "linear_atol": 1e-10,
                                 "linearIter": 4000,
                                 "preconditioner": precond}}
    jb = JaxVector(np.random.RandomState(10).rand(96), opts)
    topts = {"linearSystemArgs": dict(opts["linearSystemArgs"],
                                      report=report)}
    tb = torch_vec(jb, topts)
    for reverseGF in (False, True):
        jx = JaxVector.solve(jop, jb, 40.0, reverseGF=reverseGF)
        tx = TorchVector.solve(top, tb, 40.0, reverseGF=reverseGF)
        np.testing.assert_allclose(as_np(tx.array), np.asarray(jx.array),
                                   atol=1e-9)
    assert report["solves"] == 2 and report["matvecs"] > report["iterations"]


def test_solve_raises_on_non_convergence_like_jax():
    jop, top = _ops()[1]
    opts = {"linearSystemArgs": {"linearIter": 2, "linear_tol": 1e-12}}
    jb = JaxVector(np.random.RandomState(11).rand(96), opts)
    with pytest.raises(RuntimeError, match="did not converge"):
        JaxVector.solve(jop, jb, 40.0)
    with pytest.raises(RuntimeError, match="did not converge"):
        TorchVector.solve(top, torch_vec(jb, opts), 40.0)
    opts["linearSystemArgs"]["errorOnNonConvergence"] = False
    with pytest.warns(UserWarning, match="did not converge"):
        TorchVector.solve(top, torch_vec(jb, opts), 40.0)


@pytest.mark.parametrize("solver,sigma,match", [
    ("gmres", 40.0 + 0j, "FEAST"), ("minres", 40.0 + 1j, "FEAST")])
def test_unported_solvers_name_their_roadmap_item(solver, sigma, match):
    """A complex shift on a real operator and RHS takes the JAX package's
    split-complex single solve (ported with ``match``, the FEAST slice) in
    both packages: the same complex x to 1e-9 relative (1e-10 solve
    tolerance), counted as one lane-stack solve."""
    jop, top = _ops()[1]
    report = {}
    opts = {"linearSystemArgs": {"linearSolver": solver, "linear_tol": 1e-10,
                                 "linear_atol": 1e-10, "linearIter": 4000}}
    jb = JaxVector(np.ones(96), opts)
    jx = JaxVector.solve(jop, jb, sigma)
    opts["linearSystemArgs"]["report"] = report
    tx = TorchVector.solve(top, torch_vec(jb, opts), sigma)
    assert tx.dtype == torch.complex128
    want = np.asarray(jx.array)
    np.testing.assert_allclose(as_np(tx.array), want, rtol=0,
                               atol=1e-9 * np.abs(want).max())
    assert report["solves"] == 1 and report["matmats"] > 0


@pytest.mark.parametrize("solver", ["exact", "pardiso"])
@pytest.mark.parametrize("which", [0, 1], ids=["bsr", "dense"])
def test_exact_solve_matches_jax(solver, which):
    jop, top = _ops()[which]
    opts = {"linearSystemArgs": {"linearSolver": solver}}
    jb = JaxVector(np.random.RandomState(12).rand(96), opts)
    for reverseGF in (False, True):
        jx = JaxVector.solve(jop, jb, 0.9, reverseGF=reverseGF)
        tx = TorchVector.solve(top, torch_vec(jb, opts), 0.9,
                               reverseGF=reverseGF)
        _close(as_np(tx.array), np.asarray(jx.array))


def test_complex_shift_solves_with_gmres_when_split_is_off():
    """splitComplex=False (or complex data) takes complex GMRES in both
    packages."""
    jop, top = _ops()[1]
    opts = {"linearSystemArgs": {"linearSolver": "gmres", "linear_tol": 1e-10,
                                 "linear_atol": 1e-10, "linearIter": 4000,
                                 "splitComplex": False}}
    jb = JaxVector(np.random.RandomState(13).rand(96), opts)
    jx = JaxVector.solve(jop, jb, 40.0 + 2.0j)
    tx = TorchVector.solve(top, torch_vec(jb, opts), 40.0 + 2.0j)
    assert tx.dtype == torch.complex128
    np.testing.assert_allclose(as_np(tx.array), np.asarray(jx.array),
                               atol=1e-9)


def test_gmres_on_hermitian_routes_to_minres_and_solve_batch_matches_jax():
    jop, top = _ops()[1]
    opts = {"linearSystemArgs": {"linearSolver": "gmres", "linear_tol": 1e-10,
                                 "linear_atol": 1e-10, "linearIter": 4000}}
    b = TorchVector(np.ones(96), opts, device="cpu")
    assert TorchVector.solve(top, b, 40.0).norm() > 0
    jbs = [JaxVector(np.random.RandomState(s).rand(96), opts) for s in (1, 2)]
    jx = JaxVector.solveBatch(jop, jbs, [40.0, 20.0])
    tx = TorchVector.solveBatch(top, [torch_vec(v, opts) for v in jbs],
                                [40.0, 20.0])
    for j, t in zip(jx, tx):
        np.testing.assert_allclose(as_np(t.array), np.asarray(j.array),
                                   atol=1e-9)


def test_f32_vectors_stay_f32():
    _, top = _ops()[0]
    top32 = type(top).from_transposed(top.dataT.float(), top.idx, top.n)
    tv = [TorchVector(np.random.RandomState(s).rand(96).astype(np.float32),
                      device="cpu") for s in range(3)]
    assert TorchVector.overlapMatrix(tv).dtype == np.float32
    assert TorchVector.matrixRepresentation(top32, tv).dtype == np.float32
    out = TorchVector.solve(top32, tv[0], 0.7)
    assert out.dtype == torch.float32
    assert TorchVector.orthogonalize_against_set(out, tv[1:]).dtype == \
        torch.float32


# Every constructor a user reaches with host data: (build(data, **kw), the
# host data, whether it also takes a tensor).  Without ``device`` each
# places a numpy array on the card; with no card it raises.
_H = banded(64, bw=2, seed=1)
_ENTRY_POINTS = {
    "TorchVector": (TorchVector, lambda: np.ones(8), True),
    "DenseOperator": (DenseOperator, lambda: _H, True),
    "DiagonalOperator": (DiagonalOperator, lambda: np.ones(8), True),
    "BSROperator": (lambda d, **kw: BSROperator(
        d, np.zeros((2, 1), np.int32), 64, **kw),
        lambda: np.ones((2, 1, 32, 32)), True),
    "BSROperator.from_dense": (BSROperator.from_dense, lambda: _H, False),
    "BSROperator.from_scipy": (BSROperator.from_scipy,
                               lambda: sp.csr_matrix(_H), False),
    "BandedOperator": (lambda b, **kw: BandedOperator(b, [0], 8, **kw),
                       lambda: np.ones((1, 8)), True),
    "BandedOperator.from_dense": (BandedOperator.from_dense, lambda: _H,
                                  False),
    "as_operator(dense)": (as_operator, lambda: _H, True),
    "as_operator(scipy)": (as_operator, lambda: sp.csr_matrix(_H), False),
    "kron_sum_bsr": (lambda h, **kw: product.kron_sum_bsr(h, np.eye(4), 1,
                                                          **kw),
                     lambda: np.diag(np.arange(3.0)), False),
}


def _held(obj):
    """The tensor a vector or operator holds."""
    for name in ("array", "mat", "diag", "dataT", "bands"):
        if hasattr(obj, name):
            return getattr(obj, name)
    raise AssertionError(f"{type(obj)} holds no tensor")


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_entry_points_default_to_the_card(name, monkeypatch):
    """F3: host data with no ``device`` goes to the card, and with no card
    the constructor raises, naming device="cpu", instead of falling back to
    the CPU.  device="cpu", or a CPU tensor, lands on the CPU."""
    build, data, takes_tensor = _ENTRY_POINTS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build(data())
    assert _held(build(data(), device="cpu")).device == CPU
    if takes_tensor:
        assert _held(build(torch.as_tensor(data()))).device == CPU
