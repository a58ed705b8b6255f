"""The distributed layer of the port (``eigensolvers_tpu_torch.parallel``)
against the JAX package's, on the CPU: the port on gloo ranks (processes
spawned with ``torch.multiprocessing``, one thread each, groups joined
through a file store under ``tmp_path``, every spawn bounded by a join
timeout that fails the test), the JAX package on the 8-virtual-device mesh
of tests/conftest.py, the same numpy inputs made from a seed.  The ranks'
work is in tests/test_torch_ranks.py, which imports no jax.

Tolerances (f64): the explicit-collective products and the sharded vdot
1e-12 (summation order); Lanczos eigenvalues 1e-8 relative between the
sharded and dense runs and the JAX sharded run (the JAX test's own bound:
mesh partitioning changes reduction order, amplified by the inexact
solves); FEAST levels 1e-5 of the exact ones, as the JAX tests hold them;
the fused step 1e-8 (test_multihost.py's bound)."""

import numpy as np
import pytest
import scipy.linalg as la
import torch

import jax
import jax.numpy as jnp
from eigensolvers_tpu import JaxVector, feastDiagonalization, find_nearest
from eigensolvers_tpu import inexactLanczosDiagonalization as jax_lanczos
from eigensolvers_tpu.parallel import ShardedVector as JaxSharded
from eigensolvers_tpu.parallel import make_mesh as jax_mesh
from eigensolvers_tpu.parallel import shard_operator as jax_shard
from eigensolvers_tpu.parallel import spmd as jspmd
from eigensolvers_tpu.parallel.mesh import vector_sharding
from eigensolvers_tpu.solvers.step import block_krylov_step as jax_step

import eigensolvers_tpu as jax_pkg
import eigensolvers_tpu_torch as port
import eigensolvers_tpu_torch.parallel as tpar
from eigensolvers_tpu_torch.models.synthetic import known_spectrum_matrix
from eigensolvers_tpu_torch.parallel.launch import run_ranks
from eigensolvers_tpu_torch.solvers.step import block_krylov_step
import test_torch_ranks as ranks

TIMEOUT = 240        # a deadlocked collective fails the test, not the run


def _problem(n, seed, lo=1.0, hi=200.0):
    ev = np.linspace(lo, hi, n)
    rng = np.random.RandomState(seed)
    Q = la.qr(rng.rand(n, n))[0]
    return Q.T @ np.diag(ev) @ Q, ev, rng


@pytest.fixture(scope="module")
def lanczos_run(tmp_path_factory):
    A, ev, rng = _problem(96, 1212)
    guess = rng.rand(96)
    out = run_ranks(ranks.sharded_lanczos, 4, args=(A, guess),
                    timeout=TIMEOUT, tmpdir=tmp_path_factory.mktemp("ranks"))
    return dict(out=out, A=A, ev=ev, guess=guess,
                jmesh=jax_mesh(batch=1, shard=8))


@pytest.fixture(scope="module")
def spmd_run(tmp_path_factory):
    A100, ev100, rng100 = _problem(102, 7)
    guess100 = rng100.rand(102)
    r = np.random.RandomState(5)
    H = r.standard_normal((512, 512))
    H = (H + H.T) / 2
    x, b = r.standard_normal(512), r.standard_normal(512)
    nrb, nbpr, B = 16, 3, 32
    data = r.rand(nrb, nbpr, B, B)
    idx = np.stack([np.sort(r.choice(nrb, nbpr, replace=False))
                    for _ in range(nrb)]).astype(np.int32)
    jmesh = jax_mesh(batch=1, shard=8)
    jstate = JaxSharded(r.rand(96), None, mesh=jmesh).to_state_dict()
    out = run_ranks(ranks.spmd_and_states, 4,
                    args=(H, x, b, A100, guess100, (data, idx, nrb * B),
                          jstate),
                    timeout=TIMEOUT, tmpdir=tmp_path_factory.mktemp("ranks"))
    return dict(out=out, A100=A100, ev100=ev100, guess100=guess100, H=H,
                x=x, b=b, jmesh=jmesh, bsr=(data, idx), jstate=jstate)


def test_row_col_matvec_and_vdot_match_jax_spmd(spmd_run):
    p = spmd_run
    o = p["out"][0]
    mesh = p["jmesh"]
    xs = jax.device_put(jnp.asarray(p["x"]), vector_sharding(mesh))
    bs = jax.device_put(jnp.asarray(p["b"]), vector_sharding(mesh))
    jrow = np.asarray(jspmd.row_matvec(mesh)(
        jspmd.place_row_sharded(p["H"], mesh), xs))
    jcol = np.asarray(jspmd.col_matvec(mesh)(
        jspmd.place_col_sharded(p["H"], mesh), xs))
    jdot = float(jspmd.sharded_vdot(mesh)(xs, bs))
    for got, want in ((o["row"], jrow), (o["col"], jcol)):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(o["row"], p["H"] @ p["x"], rtol=1e-12,
                               atol=1e-12)
    assert abs(o["vdot"] - jdot) <= 1e-12 * abs(jdot) + 1e-12


def test_each_explicit_product_makes_exactly_one_collective(spmd_run):
    o = spmd_run["out"][0]
    assert o["row_counts"] == {"allgather_x": 1}
    assert o["col_counts"] == {"reduce_scatter_x": 1}
    assert o["vdot_counts"] == {"allreduce_x": 1}


def test_sharded_matches_dense(lanczos_run):
    """Counterpart of tests/test_sharded.py::test_sharded_matches_dense:
    the port's sharded run against its dense run and the JAX sharded run
    on the 8-device mesh."""
    p = lanczos_run
    o = p["out"][0]
    options = {"linearSystemArgs": {
        "linearSolver": "gcrotmk", "linearIter": 1000, "linear_tol": 1e-4}}
    JaxSharded.set_default_mesh(p["jmesh"])
    try:
        evJ, _, _ = jax_lanczos(jax_shard(p["A"], p["jmesh"]),
                                JaxSharded(p["guess"], options), 30, 6, 4,
                                1e-6, writeOut=False)
    finally:
        JaxSharded.set_default_mesh(None)
    tgt = find_nearest(o["sharded"], 30)[1]
    np.testing.assert_allclose(tgt, find_nearest(o["dense"], 30)[1],
                               rtol=1e-8)
    np.testing.assert_allclose(tgt, find_nearest(np.asarray(evJ), 30)[1],
                               rtol=1e-8)
    np.testing.assert_allclose(np.sort(o["sharded"]), np.sort(o["dense"]),
                               rtol=1e-3)
    assert o["sharded_kind"] == "ShardedVector"
    # every rank returns the same gathered states
    for other in p["out"][1:]:
        np.testing.assert_array_equal(other["sharded_vectors"][0],
                                      o["sharded_vectors"][0])


def test_sharded_accuracy(lanczos_run):
    o = lanczos_run["out"][0]
    assert abs(find_nearest(o["sharded"], 30)[1]
               - find_nearest(lanczos_run["ev"], 30)[1]) <= 1e-4
    assert o["sharded_converged"]


def test_sharded_arbitrary_length(spmd_run):
    """n = 102 over 4 ranks: zero-padded to 104, the eigenpair as the JAX
    package's dense run gives it, the padding exactly zero."""
    p = spmd_run
    ev, v, size, local = p["out"][0]["padded"]
    assert size == 104 and local == (26,) and v.shape == (104,)
    options = {"linearSystemArgs": {
        "linearSolver": "gcrotmk", "linearIter": 1000, "linear_tol": 1e-4}}
    evD, YD, _ = jax_lanczos(p["A100"], JaxVector(p["guess100"], options),
                             30, 6, 4, 1e-6, writeOut=False)
    assert abs(find_nearest(np.asarray(ev), 30)[1]
               - find_nearest(np.asarray(evD), 30)[1]) < 1e-8
    np.testing.assert_allclose(v[102:], 0.0, atol=1e-12)
    vD = np.asarray(YD[0].array)
    np.testing.assert_allclose(np.sign(vD @ v[:102]) * v[:102], vD, atol=1e-6)


def test_multi_axis_states_must_divide_the_mesh(spmd_run):
    assert "multi-axis" in spmd_run["out"][0]["multi_axis"]


def test_misplaced_mesh_is_a_type_error():
    with pytest.raises(TypeError, match="mesh BEFORE the options"):
        tpar.ShardedVector(np.ones(4), {}, mesh={"linearSystemArgs": {}})


def test_bsr_row_blocks_apply_the_gathered_x(spmd_run):
    """A block-sparse operator row-sharded over 4 ranks: each rank's block
    rows (a rectangular BSROperator) times the gathered lane stack, one
    all-gather, equal to the dense product."""
    p = spmd_run
    o = p["out"][0]
    data, idx = p["bsr"]
    D = port.BSROperator(data, idx, 512, device="cpu").to_dense().numpy()
    X = np.stack([p["x"], p["b"]])
    np.testing.assert_allclose(o["bsr"], X @ D.T, rtol=1e-12, atol=1e-11)
    assert o["bsr_local"] == ("BSROperator", False)
    assert o["bsr_counts"] == {"allgather_x": 1}


def test_state_dict_carried_from_a_jax_sharded_vector(spmd_run):
    state, size = spmd_run["out"][0]["state"]
    jstate = spmd_run["jstate"]
    assert str(state["kind"]) == "sharded" == str(jstate["kind"])
    assert size == 96
    np.testing.assert_array_equal(state["array"], np.asarray(jstate["array"]))


@pytest.fixture(scope="module")
def feast_run(tmp_path_factory):
    A, ev, rng = _problem(48, 11, 1.0, 100.0)
    window = (50.5, 56.8)               # levels 51.55, 53.66, 55.77 inside
    inside = ev[(ev > window[0]) & (ev < window[1])]
    m0 = len(inside) + 3
    G = la.qr(rng.rand(48, m0), mode="economic")[0]
    Gs = la.qr(rng.rand(48, m0), mode="economic")[0]
    B3 = la.qr(rng.rand(48, 3), mode="economic")[0]
    sig3 = [30.5, 31.5, 32.5]
    out = run_ranks(ranks.feast_runs, 4,
                    args=(A, G, m0, window, Gs, sig3, B3),
                    timeout=TIMEOUT, tmpdir=tmp_path_factory.mktemp("ranks"))
    return dict(out=out, A=A, ev=ev, inside=inside, window=window, G=G,
                m0=m0, B3=B3, sig3=sig3)


def test_batched_solves_use_b_axis(feast_run):
    """Counterpart of tests/test_sharded.py::test_batched_solves_use_b_axis:
    on a (b=2, x=2) mesh the lanes split over "b" (10 of 20 lanes on a
    rank, rows over "x"), a lane count that does not divide b pads, and
    FEAST's levels agree with the JAX package's dense run."""
    p = feast_run
    o = p["out"][0]
    assert o["place"] == (10, 24)
    assert o["lane_pad"] == (1, 0)
    A = p["A"]
    for i, x in enumerate(o["solve3"]):
        r = A @ x - p["sig3"][i] * x
        assert np.linalg.norm(-r - p["B3"][:, i]) \
            < 1e-4 * np.linalg.norm(p["B3"][:, i])     # linear_atol 1e-4
    assert o["feast_kind"] == ("ShardedVector", 24)
    # the quadrature lanes were split over "b": gathered once per solve
    assert o["feast_counts"].get("allgather_b", 0) > 0
    options = {"linearSystemArgs": {
        "linearSolver": "gcrotmk", "linearIter": 3000, "linear_tol": 1e-6,
        "linear_atol": 1e-12, "splitComplex": True}}
    evD, _, _ = feastDiagonalization(
        A, [JaxVector(p["G"][:, i], options) for i in range(p["m0"])], 4,
        "legendre", *p["window"], 1e-8, 12, writeOut=False)
    for t in p["inside"]:
        got = find_nearest(o["feast"], t)[1]
        assert abs(got - t) <= 1e-5
        assert abs(got - find_nearest(np.asarray(evD), t)[1]) <= 1e-5


def test_sharded_feast_split_complex(feast_run):
    """Counterpart of tests/test_sharded.py::
    test_sharded_feast_split_complex: forced split-complex FEAST through
    the sharded backend on a (1, 4) mesh finds every level inside."""
    o = feast_run["out"][0]
    for t in feast_run["inside"]:
        assert np.min(np.abs(o["split"] - t)) < 1e-5, (t, o["split"])


def test_lane_local_minres_makes_no_collective_in_its_loop(feast_run):
    """Counterpart of tests/test_spmd.py::
    test_lane_local_minres_zero_collectives: on a (4, 1) mesh each rank
    solves its own lane with the whole state; the only collective is the
    one all-gather over "b" after the loop."""
    o = feast_run["out"][0]
    assert o["local_counts"] == {"allgather_b": 1}
    X, conv, its = o["local"]
    assert conv.all() and (its > 0).all()
    A, B3 = feast_run["A"], feast_run["B3"]
    B = np.concatenate([B3.T, B3.T[:1]])
    for k, s in enumerate(np.linspace(50.0, 250.0, 4)):
        r = s * X[k] - A @ X[k] - B[k]
        assert np.linalg.norm(r) <= 1e-8 * np.linalg.norm(B[k]) + 1e-12
    for other in feast_run["out"][1:]:
        np.testing.assert_array_equal(other["local"][0], X)


def test_two_process_fused_step_matches_one_process(tmp_path):
    """Counterpart of tests/test_multihost.py: the fused step on two gloo
    processes (state over "x") against the same step in one process, and
    the JAX package's, on its problem.  Its solves run to rtol 1e-8, not
    1e-6: the JAX test compares two runs of ONE partitioning, while here
    the partitioned dot products change the indefinite MINRES trajectory
    at roundoff, which the recurrence carries to ~1e-2 of the solve
    tolerance (1.4e-8 at 1e-6, 1.7e-12 at 1e-10, measured on the CPU)."""
    rtol = 1e-8
    n = 64
    ev = np.linspace(1.0, 40.0, n)
    rng = np.random.RandomState(7)
    Q = np.linalg.qr(rng.rand(n, n))[0]
    A = (Q.T * ev) @ Q
    M, nBlock = 8, 2
    V = np.zeros((M, n))
    g = rng.rand(nBlock, n)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    V[:nBlock] = np.linalg.qr(g.T)[0].T
    got = run_ranks(ranks.fused_step, 2, args=(A, V, nBlock, 20.0, rtol),
                    timeout=TIMEOUT, tmpdir=tmp_path)[0]
    Vt = torch.as_tensor(V)
    one = block_krylov_step(port.DenseOperator(A, device="cpu"), Vt, nBlock,
                            Vt[:nBlock].clone(), 20.0, rtol, maxiter=400)
    ref = jax_step(jax_pkg.DenseOperator(jnp.asarray(A)), jnp.asarray(V),
                   jnp.asarray(nBlock), jnp.asarray(V[:nBlock]),
                   jnp.asarray(20.0), jnp.asarray(rtol), maxiter=400)
    for want in (one.new_vectors.numpy(), np.asarray(ref.new_vectors)):
        np.testing.assert_allclose(got["new_vectors"], want, atol=1e-8)
    for key, tol in (("h_cols", 1e-7), ("s_cols", 1e-8)):
        np.testing.assert_allclose(got[key], getattr(one, key), atol=tol)
        np.testing.assert_allclose(got[key], np.asarray(getattr(ref, key)),
                                   atol=tol)


@pytest.fixture(scope="module")
def window_run(tmp_path_factory):
    n = 100
    A, ev, rng = _problem(n, 10)
    Yg = la.qr(np.random.RandomState(5).rand(n, 6), mode="economic")[0]
    H, evH = known_spectrum_matrix(64, eigenvalues=np.linspace(1, 128, 64),
                                   seed=10)
    out = run_ranks(ranks.window_solvers, 4,
                    args=(A, Yg, 160.0, 166.0, np.asarray(H), 40.5, 56.5,
                          True),
                    timeout=TIMEOUT, tmpdir=tmp_path_factory.mktemp("ranks"))
    return dict(out=out, A=A, ev=ev, Yg=Yg, evH=evH)


def test_chebyshev_sharded(window_run):
    """Counterpart of tests/test_chebyshev.py::test_chebyshev_sharded: the
    window solver on states row-sharded over 4 ranks finds the window's
    levels to 1e-8 (the JAX test's bound), agrees with the same run on
    whole states to 1e-8, and returns sharded states; every contraction
    reduced over "x" (all-reduces and norm all-gathers issued)."""
    p = window_run
    o = p["out"][0]
    ev, conv, kind, size = o["cheb"]
    assert conv and kind == "ShardedVector" and size == 100
    true_in = p["ev"][(p["ev"] >= 160.0) & (p["ev"] <= 166.0)]
    for t in true_in:
        assert abs(find_nearest(ev, t)[1] - t) <= 1e-8
        assert abs(find_nearest(ev, t)[1]
                   - find_nearest(o["cheb_whole"], t)[1]) <= 1e-8
    assert o["cheb_counts"].get("allreduce_x", 0) > 0
    assert o["cheb_counts"].get("allgather_x", 0) > 0


def test_sharded_slicing_matches_dense(window_run):
    """Counterpart of tests/test_slicing.py::
    test_sharded_slicing_matches_dense at n = 64 (its n = 240 takes ~70 s
    on 4 gloo ranks): the whole sweep with the operator row-sharded and
    the guesses sharded over 4 ranks (KPM moments on the ranks' rows of
    the probes, FEAST windows, polish) finds the window's 8 levels to 1e-6
    with polished residuals below 1e-5, the JAX test's bounds."""
    o = window_run["out"][0]
    ev, found, res, kind = o["slicing"]
    evH = window_run["evH"]
    exact = evH[(evH >= 40.5) & (evH <= 56.5)]
    assert found == len(exact) and kind == "ShardedVector"
    np.testing.assert_allclose(ev, exact, atol=1e-6)
    assert res < 1e-5


def test_parallel_exports_the_jax_package_names():
    import eigensolvers_tpu.parallel as jpar
    assert set(jpar.__all__) <= set(tpar.__all__)
    assert len(jpar.__all__) == 13
    for name in jpar.__all__:
        assert callable(getattr(tpar, name))
    assert port.ShardedVector is tpar.ShardedVector
    assert port.shard_operator is tpar.shard_operator
