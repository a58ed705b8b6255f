"""Entry points of the port: one fused step on the card, a multi-rank dry
run, and the collective-count audit of the sharded step.

Counterpart of the repository's root ``__graft_entry__.py`` (the JAX
package's).  ``entry()`` returns one fused block-Krylov step on the CH3CN
cut with its arguments, on the card.  ``dryrun_multichip(n)`` builds an
n-rank ("b", "x") mesh, runs one step with the seeds split over "b" and the
state over "x", then the sharded FEAST on the same mesh.  ``weak_scaling``
counts the collectives of one step per operator type at 1, 2, 4 ... ranks.

Ranks: on the CPU (``device="cpu"``) n gloo ranks are started as processes
(:func:`~eigensolvers_tpu_torch.parallel.launch.run_ranks`); on the card a
process takes one NCCL rank, so n > 1 runs as n processes started by the
caller (``torchrun --nproc-per-node n``), each calling these functions, and
n = 1 runs in the calling process.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from .models.molecules import ch3cn_operator
from .models.synthetic import known_spectrum_matrix
from .ops.operators import default_device
from .ops.sparse import BSROperator
from .parallel import (ShardedVector, collective_counts,
                       distributed_initialize, make_mesh,
                       reset_collective_counts, shard_operator)
from .parallel.launch import run_ranks
from .solvers.feast import feastDiagonalization
from .solvers.step import block_krylov_step

_KINDS = ("allreduce_x", "allgather_x", "reduce_scatter_x", "allgather_b")

# Collectives of ONE fused step (8-row basis, block of 2, dense / CH3CN SoP
# / block-ELL operators), the port's own counts (PERF.md).  Per MINRES
# pass: two all-reduces over "x" (alfa, which the update of y needs, then
# the other scalars) and the operator's all-gather of x.  Once per step:
# the solve's setup (an all-reduce, and an all-gather of the ranks' norms),
# its first pass (a residual pass: one all-reduce fewer than an iterating
# one), the solutions' norms (all-gather), two CGS passes and the Gram
# matrix (three all-reduces), the new columns' apply (all-gather) and
# product (all-reduce): 4 all-reduces and 3 all-gathers net.  The JAX
# package's GSPMD schedule (static HLO ops, in-loop 3 / 4 / 3) does not
# transfer as a number; its in-loop count bounds the port's per pass.
_COLLECTIVE_BUDGET = {
    kind: {"per_pass": {"allreduce_x": 2, "allgather_x": 1},
           "one_shot": {"allreduce_x": 4, "allgather_x": 3}}
    for kind in ("dense", "sop", "bsr")}
_JAX_IN_LOOP = {"dense": 3, "sop": 4, "bsr": 3}


def _flagship(dtype, device, N=12, nModesCut=3):
    """The CH3CN cut as the flagship SoP operator."""
    op, _, _ = ch3cn_operator(N=N, nModesCut=nModesCut, dtype=dtype,
                              device=device)
    return op


def _basis(n, M, nBlock, dtype, seed=0):
    """(M, n) basis buffer whose first nBlock rows are orthonormal."""
    rng = np.random.RandomState(seed)
    V = np.zeros((M, n), dtype)
    V[:nBlock] = np.linalg.qr(rng.rand(n, nBlock))[0].T.astype(dtype)
    return V


def entry(device=None):
    """Return (fn, example_args): one fused block-Krylov step on the
    flagship model — the nBlock inexact shifted solves, orthogonalization
    and subspace column assembly — on ``device`` (default: the card)."""
    dev = default_device(device)
    dtype = np.float32
    op = _flagship(dtype, dev)
    M, nBlock = 16, 2
    V = torch.as_tensor(_basis(op.shape[0], M, nBlock, dtype), device=dev)

    def fn(op, V, nvec, seeds, sigma, rtol):
        return block_krylov_step(op, V, nvec, seeds, sigma, rtol, maxiter=100)

    return fn, (op, V, nBlock, V[:nBlock].clone(), 0.05, 1e-3)


def _on_ranks(fn, n: int, device, args=()):
    """fn(*args) on every rank of an n-rank group, returning rank 0's
    result: in this process when it is one of such a group (or n = 1,
    joining a group of one if there is none), else n gloo ranks on the
    CPU."""
    if dist.is_initialized() and dist.get_world_size() == n:
        return fn(*args)
    if n == 1 and not dist.is_initialized():
        distributed_initialize(device=device)
        return fn(*args)
    if default_device(device).type != "cpu":
        raise RuntimeError(f"{n} ranks on the card need {n} processes, one "
                           f"per card (torchrun --nproc-per-node {n}); this "
                           f"process is not in such a group")
    return run_ranks(fn, n, args=args, timeout=300)[0]


def _dryrun(n_devices, device):
    batch = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = make_mesh(batch=batch, shard=n_devices // batch, device=device)
    xdim = mesh.shape["x"]
    dtype = np.float32
    op = shard_operator(_flagship(dtype, mesh.device, N=max(8, xdim),
                                  nModesCut=2), mesh)
    n = op.n
    M, nBlock = 8, 2
    rows = slice(mesh.rank["x"] * n // xdim, (mesh.rank["x"] + 1) * n // xdim)
    V = torch.as_tensor(_basis(n, M, nBlock, dtype), device=mesh.device)
    Vloc = V[:, rows].contiguous()
    out = block_krylov_step(op, Vloc, nBlock, Vloc[:nBlock].clone(), 0.05,
                            1e-2, maxiter=50, mesh=mesh)
    nv = mesh.allgather_x(out.new_vectors)
    assert nv.shape == (nBlock, n) and out.new_vectors.shape[1] * xdim == n
    norms = torch.linalg.vector_norm(nv.double(), dim=1).cpu().numpy()
    assert np.all((np.abs(norms - 1.0) < 1e-3) | (norms < 1e-6)), norms

    # FEAST through the sharded backend on the SAME mesh: the nk*m0
    # quadrature lanes split over "b", the state over "x"
    nF = 16 * xdim
    evs = np.linspace(1.0, 40.0, nF).astype(dtype)
    rngF = np.random.RandomState(1)
    QF = np.linalg.qr(rngF.rand(nF, nF).astype(dtype))[0]
    AF = (QF.T * evs) @ QF
    m0 = 3
    GF = np.linalg.qr(rngF.rand(nF, m0).astype(dtype))[0]
    options = {"linearSystemArgs": {"linearIter": 200, "linear_tol": 1e-3,
                                    "errorOnNonConvergence": False}}
    ShardedVector.set_default_mesh(mesh)
    try:
        Y = [ShardedVector(GF[:, i], options, mesh=mesh) for i in range(m0)]
        evF, YF, _ = feastDiagonalization(
            shard_operator(AF, mesh), Y, 4, "legendre", 18.0, 22.0, 1e-3, 2,
            writeOut=False)
    finally:
        ShardedVector.set_default_mesh(None)
    assert isinstance(YF[0], ShardedVector) and YF[0].mesh is mesh
    assert YF[0].array.shape[0] * xdim == nF, "FEAST result not sharded"
    return {"mesh": (mesh.shape["b"], xdim), "n": n, "norms": norms,
            "feast_ev": np.asarray(evF)}


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One fully sharded fused step on an n-rank (b, x) mesh (b = 2 when n
    is even and at least 4), then FEAST through the sharded backend on the
    same mesh, with the JAX package's asserts.  ``device``: the card by
    default; ``"cpu"`` for gloo ranks.  Returns rank 0's summary."""
    return _on_ranks(_dryrun, n_devices, device, (n_devices, device))


def _audit_problem(kind, d, rows_per_device, dtype, device):
    """(operator, n) of the audit problem of this type at d ranks: dense
    weak-scales (fixed rows per rank); SoP and BSR at a fixed size."""
    if kind == "dense":
        n = rows_per_device * d
        H, _ = known_spectrum_matrix(n, eigenvalues=np.linspace(1, 40, n),
                                     seed=5, dtype=dtype)
        return H, n
    if kind == "sop":
        return _flagship(dtype, device, N=16, nModesCut=2), 256
    n, B, nbpr = 2048, 128, 4
    nrb = n // B
    rng = np.random.RandomState(7)
    data = rng.rand(nrb, nbpr, B, B).astype(dtype)
    idx = np.stack([np.sort(rng.choice(nrb, nbpr, replace=False))
                    for _ in range(nrb)]).astype(np.int32)
    return BSROperator(data, idx, n, device=device), n


def _audit(d, rows_per_device, reps, maxiter, device):
    """Every kind's row at d ranks (a (1, d) mesh)."""
    mesh = make_mesh(batch=1, shard=d, device=device)
    dtype = np.float32
    M, nBlock = 8, 2
    out = {}
    for kind in ("dense", "sop", "bsr"):
        raw, n = _audit_problem(kind, d, rows_per_device, dtype, mesh.device)
        op = shard_operator(raw, mesh)
        rows = slice(mesh.rank["x"] * n // d, (mesh.rank["x"] + 1) * n // d)
        V = torch.as_tensor(_basis(n, M, nBlock, dtype),
                            device=mesh.device)[:, rows].contiguous()

        def step(rtol, iters, report=None):
            return block_krylov_step(op, V, nBlock, V[:nBlock].clone(), 0.05,
                                     rtol, maxiter=iters, mesh=mesh,
                                     report=report)

        # collectives per MINRES pass and once per step: two runs that
        # never converge (rtol 0) differ only in their passes (the report's
        # lane-stack applies less the new columns' one)
        counts, passes = [], []
        for iters in (3, 6):
            reset_collective_counts()
            report = {}
            step(0.0, iters, report)
            counts.append(collective_counts())
            passes.append(report["matmats"] - 1)
        per_pass, one_shot = {}, {}
        for k in _KINDS:
            dp, dc = passes[1] - passes[0], counts[1][k] - counts[0][k]
            assert dc % dp == 0, (kind, k, dc, dp)
            per_pass[k] = dc // dp
            one_shot[k] = counts[0][k] - per_pass[k] * passes[0]
        step(1e-2, maxiter)                                    # warm
        best = float("inf")
        for _ in range(reps):
            _sync(mesh)
            t0 = time.perf_counter()
            step(1e-2, maxiter)
            _sync(mesh)
            best = min(best, time.perf_counter() - t0)
        row = {"wall_ms": best * 1e3, "n": n, "per_pass": per_pass,
               "one_shot": one_shot,
               "in_loop": sum(per_pass.values())}
        # one all-reduce of a step-sized operand on this mesh (the median
        # of 5: gloo ranks sharing a host's cores vary several-fold)
        a = torch.zeros((M, n // d), dtype=torch.float32, device=mesh.device)
        mesh.allreduce_x(a)
        times = []
        for _ in range(5):
            _sync(mesh)
            t0 = time.perf_counter()
            mesh.allreduce_x(a)
            _sync(mesh)
            times.append(time.perf_counter() - t0)
        c_ms = float(np.median(times)) * 1e3
        execs = row["in_loop"] * maxiter + sum(one_shot.values())
        row.update(collective_ms=c_ms, n_collective_execs=execs,
                   attributed_upper_ms=execs * c_ms)
        out[kind] = row
    return out


def _sync(mesh):
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def weak_scaling(n_devices: int, rows_per_device: int = 256, reps: int = 3,
                 device=None) -> dict:
    """Collective audit of the fused block-Krylov step, per operator type
    (dense row-sharded, CH3CN SoP, block-ELL BSR), at 1, 2, 4 ... up to
    ``n_devices`` ranks on (1, d) meshes: every rank runs the explicit
    schedule, so its collectives are counted as issued (the mesh's
    counters), split into per-MINRES-pass and one-shot counts.

    Asserted: both counts are the same at every mesh size (a group of one
    rank issues them too), equal to the pinned ``_COLLECTIVE_BUDGET``; the
    per-pass total is no more than the JAX package's in-loop count for the
    type; and, as the JAX package asserts, wall(d) <= d x wall(1) + 2 x
    attributed_upper_ms (execs x one all-reduce's time on that mesh).
    Walls on gloo ranks measure the host, not a speedup; the counts are
    taken from two step runs that never converge (3 and 6 passes).
    Returns {kind: {d: row}}."""
    maxiter = 50
    sizes = [d for d in (1, 2, 4, 8) if d <= n_devices]
    by_size = {d: _on_ranks(_audit, d, device,
                            (d, rows_per_device, reps, maxiter, device))
               for d in sizes}
    report = {kind: {d: by_size[d][kind] for d in sizes}
              for kind in ("dense", "sop", "bsr")}
    for kind, rows in report.items():
        want = _COLLECTIVE_BUDGET[kind]
        for d, row in rows.items():
            for part in ("per_pass", "one_shot"):
                got = {k: v for k, v in row[part].items() if v}
                assert got == want[part], \
                    (f"[{kind}] x{d} {part} collectives {got}, pinned "
                     f"{want[part]}")
            assert row["in_loop"] <= _JAX_IN_LOOP[kind], (kind, row)
            if d > 1 and 1 in rows:
                bound = d * rows[1]["wall_ms"] \
                    + 2.0 * row["attributed_upper_ms"]
                assert row["wall_ms"] <= bound, \
                    (f"[{kind}] x{d} wall {row['wall_ms']:.2f} ms exceeds "
                     f"attribution upper bound {bound:.2f} ms")
    return report
