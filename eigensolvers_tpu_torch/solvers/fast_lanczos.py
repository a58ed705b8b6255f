"""Fused inexact-Lanczos driver — the latency-optimized dense path.

Same algorithm and convergence semantics as
:func:`~eigensolvers_tpu_torch.solvers.lanczos.inexactLanczosDiagonalization`,
but each Krylov iteration (nBlock shifted solves as one lane stack,
orthogonalization, new S/H columns) is one
:func:`~eigensolvers_tpu_torch.solvers.step.block_krylov_step` against a
preallocated basis buffer on the device, and only the small m-sized
subspace columns cross to the host.

Differences from the list-based driver (documented, none affect the
convergence contract):
  * orthogonalization is conjugated CGS2 instead of the reference-quirk
    non-conjugated MGS (identical for real data up to roundoff);
  * the basis buffer is preallocated at ``nBlock*L`` rows;
  * pick functions are supported through lazy basis-row proxies whose
    ``vdot`` against a reference state is computed as ONE product per
    (iteration, reference) — state-following (maxOvlp) runs at fused-path
    speed.

Returns the same (ev, vectors, status) triple; vectors come back as the
guesses' kind (``TorchVector`` for a raw array), reconstructed from the
basis buffer, on its device.  Sharded guesses
(:class:`~eigensolvers_tpu_torch.parallel.ShardedVector`) keep this rank's
rows of the basis, and get ``ShardedVector`` results on the same mesh: the
steps run on the mesh, and every contraction over the state axis reduces
over its "x" group.
"""

from __future__ import annotations

import time
import warnings
from typing import List, Optional, Union

import numpy as np
import torch

from ..ops.linear_solvers import reduced as _reduced
from ..ops.operators import as_operator, as_tensor
from ..utils import checkpointing
from ..utils.profiling import PhaseTimer, spans, to_host
from ..utils.reporting import LanczosReporter
from ..utils.status import lanczos_status
from ..utils.subspace import (
    diagonalizeHamiltonian,
    get_pick_function_close_to_sigma,
    lowdinOrthoMatrix,
)
from ..vectors.abstract import AbstractVector
from ..vectors.dense import TorchVector
from .lanczos import analyzeStatus, checkConvergence
from .step import block_krylov_step


def _normalized_rows(G, reduce=None):
    nrm = torch.linalg.vector_norm(G, dim=1, keepdim=True)
    if reduce is not None:
        nrm = reduce(nrm, "norm")
    return G / torch.where(nrm > 0, nrm, torch.ones_like(nrm))


def _row_proxies(V, nvec, reduce=None):
    """Lazy stand-ins for the Krylov basis list, for pick functions
    (which only use ``vdot`` — both reference pick families do,
    reference: util_funcs.py:305-344): the overlap column against each
    distinct reference vector is computed once, on V's device, wherever the
    reference's array lives, and cached."""
    # cache value holds a reference to the keyed object so its id cannot be
    # reused by a new object while the entry is alive (CPython id-reuse
    # aliasing)
    cache = {}
    Vv = V[:nvec]

    class _Row:
        __slots__ = ("i",)

        def __init__(self, i):
            self.i = i

        def vdot(self, other, conjugate: bool = True):
            key = (id(other), conjugate)
            if key not in cache:
                r = as_tensor(other.array, V.device).reshape(-1)
                dtype = torch.promote_types(V.dtype, r.dtype)
                A = Vv.to(dtype)
                col = _reduced((A.conj() if conjugate else A) @ r.to(dtype),
                               reduce)
                cache[key] = (other, to_host(col).numpy())
            val = cache[key][1][self.i]
            return complex(val) if np.iscomplexobj(val) else float(val)

    return [_Row(i) for i in range(nvec)]


def fastLanczosDiagonalization(
        H, v0: Union[AbstractVector, List[AbstractVector], np.ndarray],
        sigma, L, maxit, eConv,
        Hsolve=None, status=None, pick=None,
        rtol: Optional[float] = None, solve_maxiter: Optional[int] = None,
        writeOut=False, eShift=0.0, convertUnit="au",
        outFileName=None, summaryFileName=None,
        saveEachIteration=False, saveDir="saveKrylov",
        checkFitTol=1e-7):
    """Fused-path inexact shift-and-invert (block) Lanczos.

    Accepts TorchVector(s) (options read from the first guess; the basis
    lives on its device) or a raw (nBlock, n) / (n,) array (on the card;
    a raw tensor keeps its device).
    See module docstring for the deltas vs the general driver.  Reporting
    (``writeOut`` — default off on this latency-optimized path),
    per-iteration checkpointing (``saveEachIteration``), complex/general
    shifts (routed to GMRES lanes) and
    ``linearSystemArgs["preconditioner"]`` carry the same semantics as
    :func:`~eigensolvers_tpu_torch.solvers.lanczos.inexactLanczosDiagonalization`.
    A ``linearSystemArgs["report"]`` dict accumulates the steps' "solves",
    "iterations" and operator applies ("matmats" for lane stacks).
    """
    # -- normalize inputs ----------------------------------------------------
    if isinstance(v0, AbstractVector):
        v0 = [v0]
    if isinstance(v0, (list, tuple)):
        options = getattr(v0[0], "options", {}) or {}
        guesses = torch.stack([v.array.reshape(-1) for v in v0])
        # round-trip the backend: sharded guesses give sharded results on
        # their mesh, and the steps run on it
        ref = v0[0]
        vec_cls = type(ref)
        op = vec_cls._as_operator(Hsolve if Hsolve is not None else H, ref)
        opH = vec_cls._as_operator(H, ref)
    else:
        options = {}
        arr = as_tensor(v0)
        guesses = arr[None, :] if arr.ndim == 1 else arr
        ref = TorchVector(guesses[0], options)
        vec_cls = TorchVector
        op = as_operator(Hsolve if Hsolve is not None else H, arr.device)
        opH = as_operator(H, arr.device)
    red = vec_cls._reducer(ref)
    mesh = getattr(ref, "mesh", None)
    nBlock, n = guesses.shape
    opts = options.get("linearSystemArgs", {})
    rtol = rtol if rtol is not None else opts.get("linear_tol", 1e-4)
    solve_maxiter = solve_maxiter if solve_maxiter is not None else \
        opts.get("linearIter", 1000)
    report = opts.get("report")

    # complex shifts upcast the basis buffer and route through GMRES lanes
    # (same solver-selection rule as TorchVector._solve_opts: MINRES needs
    # a Hermitian system, so it requires a real shift)
    sigma_complex = np.iscomplexobj(np.asarray(sigma))
    dtype = torch.promote_types(op.dtype, guesses.dtype)
    if sigma_complex:
        dtype = torch.promote_types(dtype, torch.complex64)
    solver = opts.get("linearSolver", "minres")
    solver = {"gcrotmk": "gmres", "pardiso": "exact"}.get(solver, solver)
    if solver not in ("minres", "gmres"):
        raise ValueError(
            f"fused driver supports linearSolver minres/gmres (alias "
            f"gcrotmk), got {solver!r}")
    solver = "gmres" if sigma_complex else "minres"
    precond = opts.get("preconditioner")
    restart = opts.get("gmresRestart", 30)

    # orthonormalize guesses via the contract whole-set QR
    # (reference: abstractVector.py:112 / util_funcs.py:170-194)
    gset = vec_cls.orthogonalize(
        [ref._like(g.to(dtype), options) for g in guesses])
    if len(gset) < nBlock:
        raise RuntimeError(
            f"only {len(gset)} of {nBlock} guess vectors are linearly "
            f"independent")
    guesses = torch.stack([g.array.reshape(-1) for g in gset])

    M = nBlock * L
    V = torch.zeros((M, n), dtype=dtype, device=guesses.device)
    V[:nBlock] = guesses
    nvec = nBlock

    def project(G):
        """<g_i | H g_j> for the rows of G: one lane-stack apply."""
        if report is not None:
            report["matmats"] = report.get("matmats", 0) + 1
        return to_host(_reduced(G.conj() @ opH.matvec_lanes(G).to(dtype).T,
                                red)).numpy()

    Hmat = project(guesses)
    Smat = np.eye(nBlock, dtype=Hmat.dtype)

    class _StatusGuess:
        hasExactAddition = True
    status = lanczos_status(status, _StatusGuess(), nBlock)

    # reporter hook (same two-file output as the general driver); the header
    # reads solver settings from a representative guess vector
    report_pick = get_pick_function_close_to_sigma(sigma) if pick is None \
        else pick
    printObj = LanczosReporter(
        ref._like(guesses[0], options), sigma, L, maxit, eConv,
        checkFitTol, status.get("writeOut", writeOut), eShift, convertUnit,
        report_pick, status, outFileName, summaryFileName)
    printObj.fileHeader()

    timer = PhaseTimer("es.fast_lanczos", V.device)
    ev = np.full(nBlock, np.nan)
    uSH = None
    continueIteration = True

    for outerIter in spans("es.fast_lanczos.outer", range(maxit)):
        status["outerIter"] = outerIter
        status["KSmaxD"] = [0]
        for innerIter in range(1, L):
            status["innerIter"] = innerIter
            status["cumIter"] += 1

            with timer.phase("fused_step"):
                out = block_krylov_step(
                    op, V, nvec, V[nvec - nBlock:nvec], sigma, rtol,
                    maxiter=solve_maxiter, solver=solver, precond=precond,
                    restart=restart, report=report, mesh=mesh)

            # solves are on normalized seeds; resnorm is absolute vs ||b||=1
            status["solveResidualMax"] = max(
                float(np.max(out.solve_resnorms)),
                status.get("solveResidualMax", 0.0))
            if np.any(out.lindep_flags):
                status["lindep"] = True
                warnings.warn(
                    f"Linear dependency in fused step at iteration "
                    f"{outerIter}/{innerIter}; stopping with current basis")
                break

            # accept new vectors: extend S/H from the fused columns
            with timer.phase("subspace_update"):
                V[nvec:nvec + nBlock] = out.new_vectors
                mtot = nvec + nBlock
                s_cols, h_cols = out.s_cols, out.h_cols
                Snew = np.zeros((mtot, mtot), dtype=s_cols.dtype)
                Snew[:nvec, :nvec] = Smat[:nvec, :nvec]
                Hnew = np.zeros((mtot, mtot), dtype=h_cols.dtype)
                Hnew[:nvec, :nvec] = Hmat[:nvec, :nvec]
                for i in range(nBlock):
                    m_i = nvec + i + 1
                    Snew[:m_i, nvec + i] = s_cols[i, :m_i]
                    Snew[nvec + i, :m_i] = s_cols[i, :m_i].conj()
                    Snew[nvec + i, nvec + i] = s_cols[i, nvec + i].real
                    Hnew[:m_i, nvec + i] = h_cols[i, :m_i]
                    Hnew[nvec + i, :m_i] = h_cols[i, :m_i].conj()
                Smat, Hmat = Snew, Hnew
                nvec = mtot

            printObj.writeFile("iteration", status)
            printObj.writeFile("overlap", Smat)

            with timer.phase("diagonalize"):
                status, uS = lowdinOrthoMatrix(
                    Smat.astype(np.complex128 if np.iscomplexobj(Smat)
                                else np.float64), status)
                ev, uv = diagonalizeHamiltonian(uS, Hmat.astype(uS.dtype))
                uSH = uS @ uv
                if pick is None:
                    idx = np.argsort(np.abs(ev - sigma))
                else:
                    idx = pick(uSH, _row_proxies(V, uSH.shape[0], red), ev)
                ev = ev[idx]
                uSH = uSH[:, idx]

            status = checkConvergence(ev, eConv, status, printObj)
            continueIteration = analyzeStatus(status, maxit, L)

            if saveEachIteration:
                # backend-neutral checkpoint of the live basis (opt-in)
                checkpointing.save_checkpoint(
                    saveDir, status["cumIter"],
                    [ref._like(V[i], options) for i in range(nvec)],
                    status, eigencoefficients=uSH, eigenvalues=ev)

            if not continueIteration:
                break
        if status.get("lindep") or not continueIteration:
            break
        # restart from the first nBlock Ritz vectors
        with timer.phase("restart"):
            coeffs = torch.as_tensor(uSH[:, :nBlock], device=V.device)
            G = _normalized_rows(coeffs.to(dtype).T @ V[:nvec], red)
            V.zero_()
            V[:nBlock] = G
            nvec = nBlock
            Hmat = project(G)
            Smat = np.eye(nBlock, dtype=Hmat.dtype)
            # uSH referred to the pre-restart basis; if the next sweep aborts
            # before producing a new one (e.g. first-iteration lindep), the
            # finalize falls back to the restart guesses — which ARE the
            # previous sweep's Ritz vectors (the stale-variable failure the
            # reference has at inexact_Lanczos.py:358).
            uSH = None

    # materialize Ritz vectors
    with timer.phase("finalize"):
        if uSH is None:
            R = V[:nvec].clone()
        else:
            coeffs = torch.as_tensor(uSH, device=V.device).to(dtype)
            R = _normalized_rows(coeffs.T @ V[:nvec], red)
    vectors = [ref._like(R[i], options) for i in range(R.shape[0])]
    status["timers"] = timer.summary()
    status["runTime"] = time.time() - status["startTime"]
    printObj.writeFile("results", ev)
    printObj.fileFooter()
    printObj.close()
    return ev, vectors, status
