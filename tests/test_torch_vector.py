"""TorchVector against JaxVector on the same vectors (state-dict round
trip) and the same operators (``operator_from_arrays``).

Tolerance: f64 throughout; the two differ only in summation order, so the
subspace matrices agree to 1e-12 relative to their largest entry."""

import numpy as np
import pytest
import torch

from eigensolvers_tpu import JaxVector
from eigensolvers_tpu.ops.operators import DenseOperator as JaxDense
from eigensolvers_tpu.ops.sparse import BSROperator as JaxBSR

from eigensolvers_tpu_torch import TorchVector
from test_torch_common import as_np, banded, dd_matrix, torch_op, torch_vec

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
                                     "array": np.zeros(3)})


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
    ("gmres", 40.0 + 0j, "FEAST"), ("minres", 40.0 + 1j, "FEAST"),
    ("exact", 40.0, "Exact solves"), ("pardiso", 40.0, "Exact solves")])
def test_unported_solvers_name_their_roadmap_item(solver, sigma, match):
    _, top = _ops()[1]
    b = TorchVector(np.ones(96), {"linearSystemArgs": {"linearSolver": solver}})
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{match}"):
        TorchVector.solve(top, b, sigma)


def test_gmres_on_hermitian_routes_to_minres_and_solve_batch_is_queued():
    _, top = _ops()[1]
    b = TorchVector(np.ones(96), {"linearSystemArgs": {"linearSolver": "gmres"}})
    assert TorchVector.solve(top, b, 40.0).norm() > 0
    with pytest.raises(NotImplementedError, match="ROADMAP.*solveBatch"):
        TorchVector.solveBatch(top, [b], [40.0])


def test_f32_vectors_stay_f32():
    _, top = _ops()[0]
    top32 = type(top)(top.dataT.float(), top.idx, top.n)
    tv = [TorchVector(np.random.RandomState(s).rand(96).astype(np.float32))
          for s in range(3)]
    assert TorchVector.overlapMatrix(tv).dtype == np.float32
    assert TorchVector.matrixRepresentation(top32, tv).dtype == np.float32
    out = TorchVector.solve(top32, tv[0], 0.7)
    assert out.dtype == torch.float32
    assert TorchVector.orthogonalize_against_set(out, tv[1:]).dtype == \
        torch.float32
