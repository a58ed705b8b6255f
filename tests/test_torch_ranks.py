"""Work run on gloo ranks by tests/test_torch_parallel.py (through
``eigensolvers_tpu_torch.parallel.launch.run_ranks``): module-level
functions that the spawned rank processes import by name.  This module
imports neither jax nor the JAX package, so a rank starts with torch and
the port only; it holds no tests itself.

Each function takes numpy inputs made by the test from a seed, runs the
port on a mesh of the group's ranks (``device="cpu"``), and returns numpy
results (the whole state gathered where a state is returned) with the
collective counts the test checks.
"""

import numpy as np
import torch

from eigensolvers_tpu_torch import (BSROperator, TorchVector,
                                    feastDiagonalization,
                                    inexactLanczosDiagonalization)
from eigensolvers_tpu_torch.ops import linear_solvers as ls
from eigensolvers_tpu_torch.parallel import (ShardedVector, col_matvec,
                                             collective_counts, make_mesh,
                                             place_col_sharded,
                                             place_row_sharded,
                                             reset_collective_counts,
                                             row_matvec, shard_operator,
                                             sharded_vdot)
from eigensolvers_tpu_torch.solvers.step import block_krylov_step

CPU = "cpu"


def _counted(fn):
    """(fn(), the collectives it issued)."""
    reset_collective_counts()
    out = fn()
    return out, {k: v for k, v in collective_counts().items() if v}


def _lanczos(A, guess, cls, sigma=30, **kw):
    options = {"linearSystemArgs": {
        "linearSolver": "gcrotmk", "linearIter": 1000, "linear_tol": 1e-4}}
    return inexactLanczosDiagonalization(
        A, cls(guess, options, **kw), sigma, 6, 4, 1e-6, writeOut=False)


def sharded_lanczos(A, guess):
    """The sharded Lanczos on a (1, world) mesh, and the dense one in this
    process."""
    mesh = make_mesh(batch=1, device=CPU)
    out = {"dense": _lanczos(A, guess, TorchVector, device=CPU)[0]}
    ev, Y, st = _lanczos(shard_operator(A, mesh), guess, ShardedVector,
                         mesh=mesh)
    out["sharded"] = ev
    out["sharded_converged"] = st["isConverged"]
    out["sharded_vectors"] = [y.to_state_dict()["array"] for y in Y]
    out["sharded_kind"] = type(Y[0]).__name__
    return out


def spmd_and_states(H, x, b, A100, guess100, bsr, jax_state):
    """On a (1, world) mesh: the explicit-collective products, a padded
    state's Lanczos, the multi-axis error, a row-sharded BSR apply, and a
    JAX state dict."""
    mesh = make_mesh(batch=1, device=CPU)
    out = {"world": mesh.shape["x"]}
    rows = slice(mesh.rank["x"] * len(x) // mesh.shape["x"],
                 (mesh.rank["x"] + 1) * len(x) // mesh.shape["x"])
    xt, bt = torch.as_tensor(x[rows]), torch.as_tensor(b[rows])
    y, out["row_counts"] = _counted(
        lambda: row_matvec(mesh)(place_row_sharded(H, mesh), xt))
    out["row"] = mesh.allgather_x(y).numpy()
    y, out["col_counts"] = _counted(
        lambda: col_matvec(mesh)(place_col_sharded(H, mesh), xt))
    out["col"] = mesh.allgather_x(y).numpy()
    v, out["vdot_counts"] = _counted(lambda: sharded_vdot(mesh)(xt, bt))
    out["vdot"] = float(v)

    ShardedVector.set_default_mesh(mesh)
    try:
        ev, Y, _ = _lanczos(A100, guess100, ShardedVector)
    finally:
        ShardedVector.set_default_mesh(None)
    out["padded"] = (ev, Y[0].to_state_dict()["array"], Y[0].size,
                     tuple(Y[0].array.shape))
    try:
        ShardedVector(np.ones((len(x) + 1, 3)), mesh=mesh)
    except ValueError as e:
        out["multi_axis"] = str(e)

    data, idx, n = bsr
    op = BSROperator(data, idx, n, device=CPU)
    sop = shard_operator(op, mesh)
    X = torch.as_tensor(np.stack([x, b]))
    Y, out["bsr_counts"] = _counted(lambda: sop.matvec_lanes(X[:, rows]))
    out["bsr_local"] = type(sop.local).__name__, sop.local.square
    out["bsr"] = mesh.allgather_x(Y).numpy()

    v = ShardedVector.from_state_dict(jax_state, mesh=mesh)
    out["state"] = (v.to_state_dict(), v.size)
    return out


def feast_runs(A, G, m0, window, Gs, sig3, B3):
    """FEAST on a (b=2, x=2) mesh with the lane stack split over "b", the
    placement hooks, a 3-lane batch solve; the forced split-complex FEAST
    on a (1, 4) mesh; and the lane-local MINRES on a (4, 1) mesh."""
    out = {}
    options = {"linearSystemArgs": {
        "linearSolver": "gcrotmk", "linearIter": 3000, "linear_tol": 1e-6,
        "linear_atol": 1e-12}}
    mesh = make_mesh(batch=2, shard=2, device=CPU)
    ref = ShardedVector(G[:, 0], options, mesh=mesh)
    out["place"] = tuple(ShardedVector._place_batch(
        torch.zeros((20, ref.array.shape[0])), ref).shape)
    out["lane_pad"] = (ShardedVector._batch_lane_pad(5, ref),
                       ShardedVector._batch_lane_pad(20, ref))
    Ash = shard_operator(A, mesh)
    bs = [ShardedVector(B3[:, i], options, mesh=mesh) for i in range(3)]
    xs = ShardedVector.solveBatch(Ash, bs, sig3)
    out["solve3"] = [x.to_state_dict()["array"] for x in xs]
    Y = [ShardedVector(G[:, i], options, mesh=mesh) for i in range(m0)]
    (evF, YF, _), out["feast_counts"] = _counted(
        lambda: feastDiagonalization(Ash, Y, 4, "legendre", *window, 1e-8,
                                     12, writeOut=False))
    out["feast"] = np.asarray(evF)
    out["feast_kind"] = (type(YF[0]).__name__, YF[0].array.shape[0])

    mesh14 = make_mesh(batch=1, shard=4, device=CPU)
    split = {"linearSystemArgs": dict(options["linearSystemArgs"],
                                      splitComplex=True)}
    ShardedVector.set_default_mesh(mesh14)
    try:
        Y = [ShardedVector(Gs[:, i], split) for i in range(Gs.shape[1])]
        evS, _, _ = feastDiagonalization(A, Y, 4, "legendre", *window,
                                         1e-8, 12, writeOut=False)
    finally:
        ShardedVector.set_default_mesh(None)
    out["split"] = np.asarray(evS)

    mesh41 = make_mesh(batch=4, shard=1, device=CPU)
    op = shard_operator(A, mesh41)
    lanes = torch.as_tensor(np.ascontiguousarray(B3.T))
    sig = np.linspace(50.0, 250.0, 4)
    B = torch.cat([lanes, lanes[:1]])                 # 4 lanes, one per rank
    res, out["local_counts"] = _counted(
        lambda: ls.minres_batch_local(mesh41, op.local, B, sig, rtol=1e-8,
                                      maxiter=2000))
    out["local"] = (res.x.numpy(), res.converged, res.iterations)
    return out


def fused_step(A, V, nBlock, sigma, rtol):
    """One fused step on a (1, world) mesh, V and the seeds row-sharded;
    returns the gathered new vectors and the columns."""
    mesh = make_mesh(batch=1, device=CPU)
    n = A.shape[0]
    k = mesh.shape["x"]
    rows = slice(mesh.rank["x"] * n // k, (mesh.rank["x"] + 1) * n // k)
    Vt = torch.as_tensor(V[:, rows].copy())
    out = block_krylov_step(shard_operator(A, mesh), Vt, nBlock,
                            Vt[:nBlock].clone(), sigma, rtol, maxiter=400,
                            mesh=mesh)
    return {"new_vectors": mesh.allgather_x(out.new_vectors).numpy(),
            "h_cols": out.h_cols, "s_cols": out.s_cols}


def window_solvers(A, Yg, rmin, rmax, H, eMin, eMax, whole):
    """On a (1, world) mesh: the Chebyshev window solver on sharded guesses
    (the whole operator, sharded by the solver), the same run on whole
    states in this process (``whole``), and spectrum slicing with the
    operator row-sharded and the guesses sharded."""
    from eigensolvers_tpu_torch import (chebyshevFilteredDiagonalization,
                                        spectrumSlicingDiagonalization)
    mesh = make_mesh(batch=1, device=CPU)
    out = {}
    Y = [ShardedVector(Yg[:, i], {}, mesh=mesh) for i in range(Yg.shape[1])]
    (ev, uv, st), out["cheb_counts"] = _counted(
        lambda: chebyshevFilteredDiagonalization(
            A, Y, 150, rmin, rmax, 1e-10, 40, writeOut=False))
    out["cheb"] = (np.asarray(ev), st["isConverged"], type(uv[0]).__name__,
                   uv[0].size)
    if whole:
        Yt = [TorchVector(Yg[:, i], {}, device=CPU)
              for i in range(Yg.shape[1])]
        out["cheb_whole"] = np.asarray(chebyshevFilteredDiagonalization(
            A, Yt, 150, rmin, rmax, 1e-10, 40, writeOut=False)[0])
    ShardedVector.set_default_mesh(mesh)
    try:
        ev, vecs, st = spectrumSlicingDiagonalization(
            shard_operator(H, mesh), eMin, eMax, nWindows=2, nc=8,
            eConv=1e-8, maxit=12, degree=300, nProbes=8, seed=7,
            vector_cls=ShardedVector, device=CPU)
    finally:
        ShardedVector.set_default_mesh(None)
    out["slicing"] = (np.asarray(ev), st["found_total"],
                      float(np.max(st["residuals"])),
                      type(vecs[0]).__name__)
    return out
