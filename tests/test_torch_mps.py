"""The port's matrix-product states (``vectors/mps.py``,
``vectors/mps_sweeps.py``) against the JAX package, on the CPU.

Both packages get the same numpy tensors and operator factors; the port
runs on ``device="cpu"``.  Gauges differ between the packages' QR/SVD, so
the comparisons are gauge-free: inner products, densified states,
eigenvalues.  Tolerances: exact tensor algebra 1e-12 (relative to the
largest entry or to the value); iterative solves 1e-8 against the dense
solution; converged eigenvalues 1e-10.
"""

import numpy as np
import pytest
import torch

import eigensolvers_tpu as J
from eigensolvers_tpu.models.synthetic import random_sop_terms
from eigensolvers_tpu.vectors import mps as jm
from eigensolvers_tpu.vectors import mps_sweeps as jms

import eigensolvers_tpu_torch as T
from eigensolvers_tpu_torch.convert import operator_from_arrays
from eigensolvers_tpu_torch.vectors import mps as tm
from eigensolvers_tpu_torch.vectors import mps_sweeps as tms

from test_torch_common import CPU, as_np

DIMS = [3, 2, 3, 3, 3, 5]


def rel(a, b):
    a, b = as_np(a), as_np(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.fixture(scope="module")
def chain():
    terms = random_sop_terms(nDim=6, dims=DIMS, nSum=3, seed=1212)
    jop = J.SumOfProductOperator.from_terms(6, DIMS, terms)
    factors = [np.asarray(f) for f in jop.factors]
    top = operator_from_arrays({"factors": factors}, CPU)
    H = np.asarray(jop.to_dense())
    ev, uv = np.linalg.eigh(H)
    return dict(jop=jop, top=top, H=H, ev=ev, uv=uv)


def states(maxD, seed, dtype=np.float64):
    return (jm.mps_random(DIMS, maxD, seed=seed, dtype=dtype),
            tm.mps_random(DIMS, maxD, seed=seed, dtype=dtype, device=CPU))


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_random_vdot_add_scale(dtype):
    """mps_random draws the same tensors; vdot, add, scale and dense agree
    to 1e-12."""
    A, At = states(6, 1, dtype)
    B, Bt = states(5, 2, dtype)
    for a, b in zip(A, At):
        np.testing.assert_array_equal(a, as_np(b))
    jv, tv = jm.mps_vdot(A, B), tm.mps_vdot(At, Bt)
    assert abs(tv - jv) <= 1e-12 * abs(jv)
    S = jm.mps_add(A, jm.mps_scale(B, 0.3 - 1.1j))
    St = tm.mps_add(At, tm.mps_scale(Bt, 0.3 - 1.1j))
    assert rel(tm.mps_dense(St), jm.mps_dense(S)) <= 1e-12


@pytest.mark.parametrize("maxD,eps", [(None, 0.0), (3, 0.0), (8, 1e-2)])
def test_compress_and_from_dense_match(maxD, eps):
    """mps_compress and mps_from_dense keep the JAX package's bonds and
    state (1e-12) and report its discarded weight."""
    A, At = states(8, 3)
    B, Bt = states(6, 4)
    C, dj = jm.mps_compress(jm.mps_add(A, B), maxD=maxD, eps=eps)
    Ct, dt = tm.mps_compress(tm.mps_add(At, Bt), maxD=maxD, eps=eps)
    assert [c.shape for c in C] == [tuple(c.shape) for c in Ct]
    assert rel(tm.mps_dense(Ct), jm.mps_dense(C)) <= 1e-12
    assert abs(dt - dj) <= 1e-12 * max(1.0, dj)
    x = np.random.RandomState(5).rand(*DIMS)
    F = jm.mps_from_dense(x, DIMS, maxD=maxD, eps=eps)
    Ft = tm.mps_from_dense(x, DIMS, maxD=maxD, eps=eps, device=CPU)
    assert [f.shape for f in F] == [tuple(f.shape) for f in Ft]
    assert rel(tm.mps_dense(Ft), jm.mps_dense(F)) <= 1e-12


@pytest.mark.parametrize("ctor", ["from_sop", "from_sop_compressed",
                                  "compress"])
def test_mpo_apply_and_sandwich(chain, ctor):
    """MPO apply and sandwich agree with the JAX package's (1e-12); the
    compressed bonds are equal."""
    if ctor == "compress":
        Wj = jm.MPO.from_sop(chain["jop"]).compress()
        Wt = tm.MPO.from_sop(chain["top"]).compress()
    else:
        Wj = getattr(jm.MPO, ctor)(chain["jop"])
        Wt = getattr(tm.MPO, ctor)(chain["top"])
    assert [w.shape for w in Wj.tensors] == [tuple(w.shape)
                                            for w in Wt.tensors]
    A, At = states(6, 6)
    B, Bt = states(5, 7)
    assert rel(tm.mps_dense(Wt.apply(Bt)), jm.mps_dense(Wj.apply(B))) <= 1e-12
    want = Wj.sandwich(A, B)
    assert abs(Wt.sandwich(At, Bt) - want) <= 1e-12 * abs(want)


def test_mpo_cache_on_port_operators(chain):
    """``_as_mpo`` caches on the port's SumOfProductOperator and
    GroupedSoPOperator (``_mpo_cache``)."""
    grouped = operator_from_arrays(
        {"dims": DIMS, "groups": [((0, 2), [np.ones((1, 3, 3)),
                                            np.eye(3)[None]])],
         "id_coeff": np.asarray(0.5)}, CPU)
    for op in (chain["top"], grouped):
        W = tm._as_mpo(op)
        assert tm._as_mpo(op) is W and op._mpo_cache[None] is W


def test_contract_methods_match(chain):
    """orthogonalize, linearCombination, overlap/matrix representation and
    their extensions agree with the JAX package's (1e-10)."""
    opts = {"compressArgs": {"maxD": 40, "eps": 1e-12}}
    jv = [jm.MPSVector.random(DIMS, 8, opts, seed=s) for s in range(4)]
    tv = [tm.MPSVector.random(DIMS, 8, opts, seed=s, device=CPU)
          for s in range(4)]
    jq, tq = jm.MPSVector.orthogonalize(jv), tm.MPSVector.orthogonalize(tv)
    assert len(tq) == len(jq) == 4
    for a, b in zip(jq, tq):
        assert rel(b.to_dense(), a.to_dense()) <= 1e-10
    np.testing.assert_allclose(tm.MPSVector.overlapMatrix(tq), np.eye(4),
                               atol=1e-10)
    lc_j = jm.MPSVector.linearCombination(jv[:3], [0.5, -1.0, 2.0])
    lc_t = tm.MPSVector.linearCombination(tv[:3], [0.5, -1.0, 2.0])
    assert rel(lc_t.to_dense(), lc_j.to_dense()) <= 1e-10
    Hj = jm.MPSVector.matrixRepresentation(chain["jop"], jq)
    Ht = tm.MPSVector.matrixRepresentation(chain["top"], tq)
    assert rel(Ht, Hj) <= 1e-10
    assert rel(tm.MPSVector.extendMatrixRepresentation(
        chain["top"], tq, Ht[:3, :3].copy()), Ht) <= 1e-12
    S = tm.MPSVector.overlapMatrix(tq)
    assert rel(tm.MPSVector.extendOverlapMatrix(tq, S[:3, :3].copy()),
               S) <= 1e-12
    assert rel(tq[2].applyOp(chain["top"]).to_dense(),
               jq[2].applyOp(chain["jop"]).to_dense()) <= 1e-10
    a, b = tq[1].copy(), jq[1].copy()
    a *= 2.0 - 1.0j
    b *= 2.0 - 1.0j
    assert rel(a.conjugate().to_dense(), b.conjugate().to_dense()) <= 1e-12
    assert abs(a.vdot(tq[0], conjugate=False)
               - b.vdot(jq[0], conjugate=False)) <= 1e-12


def test_state_dicts_cross_between_packages():
    v = jm.MPSVector.random(DIMS, 5, seed=13)
    w = tm.MPSVector.from_state_dict(v.to_state_dict(), device=CPU)
    back = jm.MPSVector.from_state_dict(w.to_state_dict())
    for a, b, c in zip(v.tensors, w.tensors, back.tensors):
        np.testing.assert_array_equal(a, as_np(b))
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("linear,sigma", [
    ({"linearSolver": "minres"}, 3.7),
    ({"linearSolver": "bicgstab"}, 3.7 + 0.4j),
    ({"method": "als", "nSweep": 20, "convTol": 1e-10, "siteTol": 1e-10},
     3.7),
    ({"method": "als", "nSweep": 20, "convTol": 1e-10, "siteTol": 1e-10},
     3.7 + 0.4j)])
def test_solve_matches_dense(chain, linear, sigma):
    """MPSVector.solve — compressed MINRES (real shift), BiCGStab (complex
    shift), ALS sweeps — reaches the dense solution to 1e-8, as the JAX
    package's solve does."""
    opts = {"compressArgs": {"maxD": 120, "eps": 1e-13},
            "linearSystemArgs": dict(linear, linearIter=400,
                                     linear_tol=1e-11, maxD=120, eps=1e-13)}
    B, Bt = states(6, 8)
    H = chain["H"]
    want = np.linalg.solve(sigma * np.eye(len(H)) - H, jm.mps_dense(B).ravel())
    report = {}
    opts["linearSystemArgs"]["report"] = report
    xt = tm.MPSVector.solve(chain["top"], tm.MPSVector(Bt, opts), sigma)
    del opts["linearSystemArgs"]["report"]
    xj = jm.MPSVector.solve(chain["jop"], jm.MPSVector(B, opts), sigma)
    assert rel(xt.to_dense().ravel(), want) <= 1e-8
    assert rel(np.asarray(xj.to_dense()).ravel(), want) <= 1e-8
    assert report == {"solves": 1}


def test_chain_dmrg_matches(chain):
    """Chain DMRG: the three lowest eigenvalues agree with the JAX
    package's to 1e-10, and with the dense ones to 1e-9 (the local
    solvers' residual tolerance bounds both packages there)."""
    Wj = jm.MPO.from_sop_compressed(chain["jop"])
    Wt = tm.MPO.from_sop_compressed(chain["top"])
    kw = dict(nStates=3, maxD=60, nSweep=30, convTol=1e-13, seed=3)
    ej, _ = jms.dmrg_eigensolve(Wj.tensors, DIMS, **kw)
    et, xt = tms.dmrg_eigensolve(Wt.tensors, DIMS, **kw)
    np.testing.assert_allclose(et, ej, rtol=1e-10)
    np.testing.assert_allclose(et, chain["ev"][:3], rtol=1e-9)
    assert all(t.device == CPU for t in xt[0])


def test_chain_als_matches_jax(chain):
    """als_solve at a tight bond (an inexact solve, the regime the Lanczos
    loop runs in) gives the JAX package's solution (1e-8)."""
    Wj = jm.MPO.from_sop_compressed(chain["jop"])
    Wt = tm.MPO.from_sop_compressed(chain["top"])
    B, Bt = states(4, 9)
    kw = dict(maxD=6, eps=1e-12, nSweep=4, convTol=1e-12, local_tol=1e-12)
    xj = jms.als_solve(Wj.tensors, B, 3.7, **kw)
    xt = tms.als_solve(Wt.tensors, Bt, 3.7, **kw)
    assert rel(tm.mps_dense(xt), jm.mps_dense(xj)) <= 1e-8


def test_mps_lanczos_matches_jax(chain):
    """Inexact Lanczos on MPS vectors: the Ritz value nearest sigma agrees
    with the JAX package's and the exact level to 1e-8."""
    sigma = float(J.calculateTarget(chain["ev"], 4))
    opts = {"compressArgs": {"maxD": 80, "eps": 1e-10},
            "linearSystemArgs": {"linearSolver": "minres", "linearIter": 400,
                                 "linear_tol": 1e-4, "maxD": 80,
                                 "eps": 1e-10}}
    got = []
    for pkg, mod, op, dev in ((J, jm, chain["jop"], {}),
                              (T, tm, chain["top"], {"device": CPU})):
        Y0 = mod.MPSVector.random(DIMS, 30, opts, seed=1212, **dev)
        evL, _, st = pkg.inexactLanczosDiagonalization(
            op, Y0, sigma, 12, 6, 1e-10, writeOut=False)
        got.append(pkg.find_nearest(evL, sigma)[1])
    want = J.find_nearest(chain["ev"], sigma)[1]
    assert abs(got[1] - got[0]) <= 1e-8 * abs(want)
    assert abs(got[1] - want) <= 1e-8 * abs(want)


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a CUDA device, constructors from host data raise and name
    device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tm.mps_random(DIMS, 4)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tm.MPSVector.random(DIMS, 4)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tm.MPSVector.from_dense(np.ones(DIMS), DIMS)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tms.dmrg_eigensolve([np.ones((1, 2, 2, 1))], [2])


def test_local_eigensolver_spelled_out():
    """The sweeps' local eigensolver, spelled out as what the JAX package's
    LOBPCG-then-ARPACK call computes on every scipy: a start whose residual
    is within tol is kept (with its Rayleigh quotient), any other start goes
    to ARPACK for the lowest pair (1e-8), and a deflated problem always
    does."""
    rng = np.random.RandomState(2)
    Q = np.linalg.qr(rng.standard_normal((40, 40)))[0]
    lam = np.linspace(-3.0, 5.0, 40)
    A = (Q * lam) @ Q.T
    mv = lambda v: A @ np.asarray(v).reshape(-1)  # noqa: E731
    fail = lambda: (None, None)  # noqa: E731
    e, v = tms.local_lowest(mv, rng.standard_normal(40), 1e-10, 40,
                            np.float64, fail)
    assert abs(e - lam[0]) <= 1e-8 * abs(lam[0])
    assert abs(abs(v @ Q[:, 0]) - 1) <= 1e-8
    e, v = tms.local_lowest(mv, 3 * Q[:, 7], 1e-10, 40, np.float64, fail)
    assert abs(e - lam[7]) <= 1e-12 and np.allclose(v, Q[:, 7])
    e, _ = tms.local_lowest(mv, Q[:, 7], 1e-10, 40, np.float64, fail,
                            keep_converged=False)
    assert abs(e - lam[0]) <= 1e-8 * abs(lam[0])
