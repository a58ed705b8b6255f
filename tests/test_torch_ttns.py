"""The port's tree tensor networks (``vectors/ttns.py``,
``vectors/ttns_sweeps.py``) and the CH3CN tree model against the JAX
package, on the CPU.

Both packages get the same numpy tensors (``RandomState`` draws, the same
in both) and the same operator factors; the port runs on
``device="cpu"``.  Gauges of QR/SVD/eigh factors may differ between the
packages, so results are compared by gauge-free quantities only: inner
products, densified states, eigenvalues, residuals.  Tolerances: exact
tensor algebra 1e-12 (relative to the largest entry, or to the value);
iterative solves 1e-8 against the dense solution; converged eigenvalues
1e-10.
"""

import numpy as np
import pytest
import torch

import eigensolvers_tpu as J
from eigensolvers_tpu.models import molecules as jmol
from eigensolvers_tpu.models.synthetic import random_sop_terms
from eigensolvers_tpu.vectors import ttns as jt
from eigensolvers_tpu.vectors import ttns_sweeps as jts

import eigensolvers_tpu_torch as T
from eigensolvers_tpu_torch.convert import operator_from_arrays
from eigensolvers_tpu_torch.models import molecules as tmol
from eigensolvers_tpu_torch.vectors import ttns as tt
from eigensolvers_tpu_torch.vectors import ttns_sweeps as tts

from test_torch_common import CPU, as_np

PARENTS = (-1, 0, 0, 2, 2, 4)        # root -> {1, 2}, 2 -> {3, 4}, 4 -> {5}
DIMS = [3, 2, 3, 3, 3, 5]


def rel(a, b):
    a, b = as_np(a), as_np(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def pair_op(dims, nSum, seed):
    """The same random sum-of-products operator in both packages."""
    terms = random_sop_terms(nDim=len(dims), dims=dims, nSum=nSum, seed=seed)
    jop = J.SumOfProductOperator.from_terms(len(dims), dims, terms)
    top = operator_from_arrays(
        {"factors": [np.asarray(f) for f in jop.factors]}, CPU)
    return jop, top


@pytest.fixture(scope="module")
def tree():
    jop, top = pair_op(DIMS, 3, 1212)
    H = np.asarray(jop.to_dense())
    ev, uv = np.linalg.eigh(H)
    return dict(jtopo=jt.TreeTopology(PARENTS), ttopo=tt.TreeTopology(PARENTS),
                jop=jop, top=top, H=H, ev=ev, uv=uv)


def states(tree, maxD, seed, dtype=np.float64):
    return (jt.ttns_random(tree["jtopo"], DIMS, maxD, seed=seed, dtype=dtype),
            tt.ttns_random(tree["ttopo"], DIMS, maxD, seed=seed, dtype=dtype,
                           device=CPU))


def test_topology_and_layout_match():
    """TreeTopology, parseTree and tree_layout give the JAX package's
    trees."""
    nested = [[], [[], [[]]]]
    assert tt.parseTree(nested).parents == jt.parseTree(nested).parents
    assert tt.TreeTopology(PARENTS).children == \
        jt.TreeTopology(PARENTS).children
    assert tt.TreeTopology.chain(4).parents == jt.TreeTopology.chain(4).parents
    a, pa = tt.tree_layout(([0], [([1, 2], []), ([], [([3], [])])]))
    b, pb = jt.tree_layout(([0], [([1, 2], []), ([], [([3], [])])]))
    assert a.parents == b.parents and pa == pb


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_random_vdot_add_scale_dense(tree, dtype):
    """ttns_random draws the same tensors; vdot, add, scale and dense agree
    to 1e-12."""
    A, At = states(tree, 6, 1, dtype)
    B, Bt = states(tree, 5, 2, dtype)
    for a, b in zip(A, At):
        np.testing.assert_array_equal(a, as_np(b))
    jv, tv = jt.ttns_vdot(tree["jtopo"], A, B), tt.ttns_vdot(tree["ttopo"],
                                                            At, Bt)
    assert abs(tv - jv) <= 1e-12 * abs(jv)
    S = jt.ttns_add(tree["jtopo"], A, jt.ttns_scale(B, -0.7 + 0.2j))
    St = tt.ttns_add(tree["ttopo"], At, tt.ttns_scale(Bt, -0.7 + 0.2j))
    assert rel(tt.ttns_dense(tree["ttopo"], St),
               jt.ttns_dense(tree["jtopo"], S)) <= 1e-12


@pytest.mark.parametrize("maxD,eps", [(None, 0.0), (4, 0.0), (8, 1e-3)])
def test_compress_matches(tree, maxD, eps):
    """Compression keeps the same bonds and the same state (1e-12), and
    reports the same discarded weight."""
    A, At = states(tree, 8, 5)
    B, Bt = states(tree, 6, 6)
    C, dj = jt.ttns_compress(tree["jtopo"], jt.ttns_add(tree["jtopo"], A, B),
                             maxD=maxD, eps=eps)
    Ct, dt = tt.ttns_compress(tree["ttopo"],
                              tt.ttns_add(tree["ttopo"], At, Bt),
                              maxD=maxD, eps=eps)
    assert [c.shape for c in C] == [tuple(c.shape) for c in Ct]
    assert rel(tt.ttns_dense(tree["ttopo"], Ct),
               jt.ttns_dense(tree["jtopo"], C)) <= 1e-12
    assert abs(dt - dj) <= 1e-12 * max(1.0, abs(dj))


def test_embed_physical_matches():
    parts = [[], [0, 1], [2]]
    topo_j, topo_t = jt.TreeTopology((-1, 0, 0)), tt.TreeTopology((-1, 0, 0))
    dims = [1, 9, 3]
    A = jt.ttns_random(topo_j, dims, 4, seed=3)
    B = jt.ttns_embed_physical(A, parts, 3, 5)
    Bt = tt.ttns_embed_physical(A, parts, 3, 5, device=CPU)
    for b, bt in zip(B, Bt):
        np.testing.assert_array_equal(b, as_np(bt))


@pytest.mark.parametrize("ctor", ["from_sop", "from_sop_compressed"])
def test_ttno_apply_and_sandwich(tree, ctor):
    """TTNO apply (densified) and sandwich agree with the JAX package's to
    1e-12, the port's sandwich being a zipper; the compressed edge ranks
    are equal."""
    Wj = getattr(jt.TTNO, ctor)(tree["jtopo"], tree["jop"])
    Wt = getattr(tt.TTNO, ctor)(tree["ttopo"], tree["top"])
    assert [w.shape for w in Wj.tensors] == [tuple(w.shape)
                                            for w in Wt.tensors]
    A, At = states(tree, 6, 6)
    B, Bt = states(tree, 5, 7)
    assert rel(tt.ttns_dense(tree["ttopo"], Wt.apply(Bt)),
               jt.ttns_dense(tree["jtopo"], Wj.apply(B))) <= 1e-12
    want = Wj.sandwich(A, B)
    assert abs(Wt.sandwich(At, Bt) - want) <= 1e-12 * abs(want)
    dense = np.vdot(jt.ttns_dense(tree["jtopo"], A),
                    tree["H"] @ jt.ttns_dense(tree["jtopo"], B))
    assert abs(Wt.sandwich(At, Bt) - dense) <= 1e-10 * abs(dense)


def test_ttno_cache_on_port_operators(tree):
    """The port's operators keep the TTNO cache (``_ttno_cache``) the
    vector backend sets on them."""
    v = tt.TTNSVector.random(tree["ttopo"], DIMS, 4, device=CPU)
    W = v._mpo(tree["top"])
    assert v._mpo(tree["top"]) is W
    assert isinstance(tree["top"]._ttno_cache, dict)


def test_contract_methods_match(tree):
    """orthogonalize, linearCombination, overlap/matrix representation and
    their extensions agree with the JAX package's (1e-10)."""
    opts = {"compressArgs": {"maxD": 40, "eps": 1e-12}}
    jv = [jt.TTNSVector.random(tree["jtopo"], DIMS, 8, opts, seed=s)
          for s in range(4)]
    tv = [tt.TTNSVector.random(tree["ttopo"], DIMS, 8, opts, seed=s,
                               device=CPU) for s in range(4)]
    jq, tq = jt.TTNSVector.orthogonalize(jv), tt.TTNSVector.orthogonalize(tv)
    assert len(jq) == len(tq) == 4
    np.testing.assert_allclose(tt.TTNSVector.overlapMatrix(tq), np.eye(4),
                               atol=1e-10)
    for a, b in zip(jq, tq):
        assert rel(b.to_dense(), a.to_dense()) <= 1e-10
    lc_j = jt.TTNSVector.linearCombination(jv[:3], [0.5, -1.0, 2.0])
    lc_t = tt.TTNSVector.linearCombination(tv[:3], [0.5, -1.0, 2.0])
    assert rel(lc_t.to_dense(), lc_j.to_dense()) <= 1e-10
    Hj = jt.TTNSVector.matrixRepresentation(tree["jop"], jq)
    Ht = tt.TTNSVector.matrixRepresentation(tree["top"], tq)
    assert rel(Ht, Hj) <= 1e-10
    Hext = tt.TTNSVector.extendMatrixRepresentation(tree["top"], tq,
                                                    Ht[:3, :3].copy())
    assert rel(Hext, Ht) <= 1e-12
    S = tt.TTNSVector.overlapMatrix(tq)
    assert rel(tt.TTNSVector.extendOverlapMatrix(tq, S[:3, :3].copy()),
               S) <= 1e-12
    a, b = jq[1].applyOp(tree["jop"]), tq[1].applyOp(tree["top"])
    assert rel(b.to_dense(), a.to_dense()) <= 1e-10


def test_state_dicts_cross_between_packages(tree):
    """A JAX state dict loads into the port and back, the tensors exact."""
    v = jt.TTNSVector.random(tree["jtopo"], DIMS, 5, seed=13)
    w = tt.TTNSVector.from_state_dict(v.to_state_dict(), device=CPU)
    assert w.topo == tree["ttopo"]
    back = jt.TTNSVector.from_state_dict(w.to_state_dict())
    for a, b, c in zip(v.tensors, w.tensors, back.tensors):
        np.testing.assert_array_equal(a, as_np(b))
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("sigma,sign", [(3.7, 1.0), (3.7, -1.0),
                                        (3.7 + 0.4j, 1.0)])
def test_tree_als_matches_dense(tree, sigma, sign):
    """Tree ALS solves (real and complex shifts, both signs) reach the
    dense solution to 1e-8, as the JAX package's do."""
    B, Bt = states(tree, 6, 4)
    Wj = jt.TTNO.from_sop(tree["jtopo"], tree["jop"])
    Wt = tt.TTNO.from_sop(tree["ttopo"], tree["top"])
    kw = dict(sign=sign, maxD=80, eps=1e-12, nSweep=20, convTol=1e-10,
              local_tol=1e-10)
    xj = jts.tree_als_solve(tree["jtopo"], Wj.tensors, B, sigma, **kw)
    xt = tts.tree_als_solve(tree["ttopo"], Wt.tensors, Bt, sigma, **kw)
    H = tree["H"]
    want = np.linalg.solve(sign * (sigma * np.eye(len(H)) - H),
                           jt.ttns_dense(tree["jtopo"], B))
    assert rel(tt.ttns_dense(tree["ttopo"], xt), want) <= 1e-8
    assert rel(jt.ttns_dense(tree["jtopo"], xj), want) <= 1e-8


@pytest.mark.parametrize("linear,sigma", [
    ({"linearSolver": "minres"}, 3.7),
    ({"linearSolver": "bicgstab"}, 3.7 + 0.4j),
    ({"method": "als", "nSweep": 20, "convTol": 1e-10, "siteTol": 1e-10},
     3.7)])
def test_vector_solve_matches_dense(tree, linear, sigma):
    """TTNSVector.solve: compressed MINRES (real shift), BiCGStab (complex
    shift) and ALS sweeps reach the dense solution to 1e-8."""
    opts = {"compressArgs": {"maxD": 80, "eps": 1e-13},
            "linearSystemArgs": dict(linear, linearIter=400,
                                     linear_tol=1e-11, maxD=80, eps=1e-13)}
    B, Bt = states(tree, 6, 8)
    b = tt.TTNSVector(Bt, opts, topo=tree["ttopo"])
    x = tt.TTNSVector.solve(tree["top"], b, sigma)
    H = tree["H"]
    want = np.linalg.solve(sigma * np.eye(len(H)) - H,
                           jt.ttns_dense(tree["jtopo"], B))
    assert rel(x.to_dense(), want) <= 1e-8


def test_tree_dmrg_matches(tree):
    """Tree DMRG: the three lowest eigenvalues agree with the JAX
    package's to 1e-10, and with the dense ones to 1e-9 (both packages
    stop there: their LOBPCG ground-state solves end at a 1e-11 residual
    tolerance, 3e-10 in the eigenvalue)."""
    Wj = jt.TTNO.from_sop(tree["jtopo"], tree["jop"])
    Wt = tt.TTNO.from_sop(tree["ttopo"], tree["top"])
    kw = dict(nStates=3, maxD=60, nSweep=30, convTol=1e-13, seed=3)
    ej, _ = jts.tree_dmrg_eigensolve(tree["jtopo"], Wj.tensors, DIMS, **kw)
    et, xt = tts.tree_dmrg_eigensolve(tree["ttopo"], Wt.tensors, DIMS, **kw)
    np.testing.assert_allclose(et, ej, rtol=1e-10)
    np.testing.assert_allclose(et, tree["ev"][:3], rtol=1e-9)
    assert all(t.device == CPU for t in xt[0])


def test_chain_topology_reproduces_mps():
    """A chain TTNS gives the MPS backend's applyOp and vdot (1e-12)."""
    dims = [3, 4, 3, 2]
    jop, top = pair_op(dims, 2, 7)
    x = np.random.RandomState(0).rand(*dims)
    vm = T.MPSVector.from_dense(x, dims, device=CPU)
    ts = list(vm.tensors)
    ts[-1] = ts[-1][:, :, 0]
    vt = tt.TTNSVector(ts, topo=tt.TreeTopology.chain(4))
    assert rel(vt.to_dense().reshape(dims), x) <= 1e-12
    a, b = vt.applyOp(top), vm.applyOp(top)
    assert rel(a.to_dense().ravel(), b.to_dense().ravel()) <= 1e-12
    assert abs(a.vdot(vt) - b.vdot(vm)) <= 1e-12 * abs(b.vdot(vm))


def test_tree_lanczos_matches_jax(tree):
    """A small-tree inexact Lanczos: the Ritz value nearest sigma agrees
    with the JAX package's and the exact level to 1e-8."""
    ev = tree["ev"]
    sigma = float(J.calculateTarget(ev, 4))
    opts = {"compressArgs": {"maxD": 60, "eps": 1e-10},
            "linearSystemArgs": {"linearSolver": "minres", "linearIter": 300,
                                 "linear_tol": 1e-5, "maxD": 60,
                                 "eps": 1e-10}}
    out = []
    for pkg, mod, topo, op, dev in (
            (J, jt, tree["jtopo"], tree["jop"], {}),
            (T, tt, tree["ttopo"], tree["top"], {"device": CPU})):
        Y0 = mod.TTNSVector.random(topo, DIMS, 8, opts, seed=11, **dev)
        evL, uv, st = pkg.inexactLanczosDiagonalization(
            op, Y0, sigma, 10, 6, 1e-10, writeOut=False)
        out.append(pkg.find_nearest(evL, sigma)[1])
    want = J.find_nearest(ev, sigma)[1]
    assert abs(out[1] - out[0]) <= 1e-8 * abs(want)
    assert abs(out[1] - want) <= 1e-8 * abs(want)


def test_tree_feast_matches_jax():
    """A small-tree FEAST (tests/test_feast_ttns.py at a reduced size: a
    72-dim tree, 4 contour nodes, 10 iterations, ALS solves at complex
    shifts): every level of the window agrees with the JAX package's and
    the dense one to 1e-8."""
    parents, dims = (-1, 0, 0, 2, 2), [2, 2, 3, 2, 3]
    jop, top = pair_op(dims, 3, 77)
    evE = np.linalg.eigvalsh(np.asarray(jop.to_dense()))
    eMin, eMax = float((evE[3] + evE[4]) / 2), float((evE[6] + evE[7]) / 2)
    true_in = evE[(evE > eMin) & (evE < eMax)]
    opts = {"compressArgs": {"maxD": 40, "eps": 1e-12},
            "linearSystemArgs": {"method": "als", "nSweep": 10,
                                 "convTol": 1e-10, "siteTol": 1e-10,
                                 "linearIter": 400, "linear_tol": 1e-8,
                                 "maxD": 40, "eps": 1e-12}}
    found = []
    for pkg, mod, op, dev in ((J, jt, jop, {}), (T, tt, top, {"device": CPU})):
        topo = mod.TreeTopology(parents)
        Y = [mod.TTNSVector(mod.ttns_random(topo, dims, 6, seed=s, **dev),
                            opts, topo=topo).normalize()
             for s in range(len(true_in) + 1)]
        ev, uv, status = pkg.feastDiagonalization(
            op, Y, 4, "legendre", eMin, eMax, 1e-10, 10, writeOut=False)
        assert status["flagAddition"] is False
        found.append([pkg.find_nearest(ev, t)[1] for t in true_in])
    np.testing.assert_allclose(found[1], found[0], rtol=1e-8)
    np.testing.assert_allclose(found[1], true_in, rtol=1e-8)


def test_ch3cn_tree_model_matches():
    """ch3cn_tree and ch3cn_tree_operator(N=3): the same topology, parts,
    node dims and (identity-padded) factors as the JAX package's."""
    (ta, pa), (tb, pb) = tmol.ch3cn_tree(), jmol.ch3cn_tree()
    assert ta.parents == tb.parents and pa == pb
    top, ttopo, tparts, _ = tmol.ch3cn_tree_operator(N=3, device=CPU)
    jop, jtopo, jparts, _ = jmol.ch3cn_tree_operator(N=3)
    assert top.dims == tuple(jop.dims) and tparts == jparts
    assert top.dims == tuple(3 ** len(p) for p in jparts)
    for a, b in zip(top.factors, jop.factors):
        np.testing.assert_allclose(as_np(a), np.asarray(b), rtol=0,
                                   atol=1e-12 * float(np.abs(b).max()))


def test_ttns_random_production_scale_bonds():
    """Bond arithmetic stays in Python ints at 42^12 (int64 overflows)."""
    topo, parts = tmol.ch3cn_tree()
    ts = tt.ttns_random(topo, [42 ** len(p) for p in parts], maxD=3, seed=1,
                        device=CPU)
    assert all(d > 0 for t in ts for d in t.shape)


def _np_sandwich(topo, bra, W, ket):
    """<bra|W|ket> with numpy, leaf to root, each node one einsum on a
    memory-capped greedy path (a reference independent of both packages'
    contraction code)."""
    down = [None] * len(topo)
    for i in range(len(topo) - 1, -1, -1):
        ch = topo.children[i]
        k = len(ch)
        ops = [bra[i].conj(), [0, 3] + [5 + 3 * j for j in range(k)],
               W[i], [1, 3, 4] + [6 + 3 * j for j in range(k)],
               ket[i], [2, 4] + [7 + 3 * j for j in range(k)]]
        for j, c in enumerate(ch):
            ops += [down[c], [5 + 3 * j, 6 + 3 * j, 7 + 3 * j]]
        down[i] = np.einsum(*ops, [0, 1, 2], optimize=("greedy", 2e8))
    return down[0][0, 0, 0]


def test_committed_ch3cn_state_energy_matches():
    """The committed N = 8 excited state of the production ladder
    (artifacts/ch3cn_tree_excited_N8_b0.npz, bond 32) loads into both
    packages; its <psi|H|psi> through the port's TTNO and zipper equals the
    JAX package's TTNO contracted by numpy, to 1e-10 relative."""
    path = "artifacts/ch3cn_tree_excited_N8_b0.npz"
    import pathlib
    z = dict(np.load(pathlib.Path(__file__).resolve().parents[1] / path))
    top, ttopo, _, _ = tmol.ch3cn_tree_operator(N=8, device=CPU)
    jop, jtopo, _, _ = jmol.ch3cn_tree_operator(N=8)
    v = tt.TTNSVector.from_state_dict(z, topo=ttopo, device=CPU)
    assert v.maxD == 32
    xs = [z[f"t{i}"] for i in range(len(jtopo))]
    Wj = jt.TTNO.from_sop_compressed(jtopo, jop)
    Wt = tt.TTNO.from_sop_compressed(ttopo, top)
    assert Wt.ranks == [w.shape[0] for w in Wj.tensors[1:]]
    want = _np_sandwich(jtopo, xs, Wj.tensors, xs) / \
        jt.ttns_vdot(jtopo, xs, xs)
    got = Wt.sandwich(v.tensors, v.tensors) / v.vdot(v)
    assert abs(got - want) <= 1e-10 * abs(want)
    # an excited state of the nu8 pair: 361 cm-1 above the zero point
    from eigensolvers_tpu.utils.units import au2unit
    assert 10198.0 < float(au2unit(got, "cm-1")) < 10199.0


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a CUDA device, the constructors that take host data raise
    and name device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    topo = tt.TreeTopology(PARENTS)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tt.ttns_random(topo, DIMS, 4)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tt.TTNSVector.random(topo, DIMS, 4)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tmol.ch3cn_tree_operator(N=2)
    W = [np.ones((1, 1, 1))]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tts.tree_dmrg_eigensolve(tt.TreeTopology((-1,)), W, [1])
