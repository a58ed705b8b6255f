"""One fused block-Krylov step — the per-iteration work of
:func:`~eigensolvers_tpu_torch.solvers.fast_lanczos.fastLanczosDiagonalization`.

One ``block_krylov_step`` call performs, with the vectors on the device:
the nBlock inexact shifted solves as ONE lane stack (batched MINRES, one
multi-vector operator apply per iteration; GMRES lanes for a complex
shift), CGS2 orthogonalization of the new vectors against the valid rows
of the basis buffer, their mutual orthonormalization by a masked Cholesky
of their Gram matrix, and the new overlap/Hamiltonian columns through one
multi-vector apply and one product.  Only the small (nBlock, nBlock) Gram
matrix and the (2*nBlock, M) columns cross to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.linear_solvers import gmres_batch, minres_batch
from ..ops.operators import require_true_fp32


class KrylovStepResult(NamedTuple):
    new_vectors: torch.Tensor   # (nBlock, n) orthonormalized Krylov vectors
    h_cols: np.ndarray          # (nBlock, M) new H columns
    s_cols: np.ndarray          # (nBlock, M) new S columns
    solve_resnorms: np.ndarray  # (nBlock,)
    lindep_flags: np.ndarray    # (nBlock,) True where orthogonalization collapsed


def _masked_cholesky(G, lindep):
    """G = L L^H on the host, in G's own dtype, with each pivot that is not
    above ``lindep`` skipped (unit diagonal, zero column): the pivot d_i is
    the squared norm of x_i orthogonalized against the previous block
    vectors, so ``d_i > lindep`` is the sequential path's lindep test.
    Returns (L, oks)."""
    nBlock = G.shape[0]
    L = np.zeros_like(G)
    oks = np.zeros(nBlock, bool)
    for i in range(nBlock):
        d = np.real(G[i, i])
        for k in range(i):
            d = d - abs(L[i, k]) ** 2
        oks[i] = d > lindep
        L[i, i] = np.sqrt(d) if oks[i] else 1.0
        for j in range(i + 1, nBlock):
            s = G[j, i]
            for k in range(i):
                s = s - L[j, k] * np.conj(L[i, k])
            L[j, i] = s / L[i, i] if oks[i] else 0.0
    return L, oks


def block_krylov_step(op, V, nvec, seeds, sigma, rtol, maxiter=200,
                      lindep=1e-14, solver="minres", precond=None,
                      restart=30, report=None) -> KrylovStepResult:
    """One block-Lanczos Krylov step, fused.

    :param op: operator (Hermitian)
    :param V: (M, n) basis buffer, rows >= nvec zero.  Valid rows MUST be
        mutually orthonormal (the Krylov iteration maintains this
        invariant); classical Gram-Schmidt projections against a
        non-orthonormal set do not orthogonalize.
    :param nvec: number of valid rows in V
    :param seeds: (nBlock, n) right-hand sides (the latest block vectors)
    :param sigma: shift (complex shifts require ``solver="gmres"`` and a
        complex-dtype basis buffer)
    :param solver: inner shifted solver — "minres" (Hermitian system, the
        default) or "gmres" (general/complex shifts)
    :param precond: None or "jacobi"
    :param restart: GMRES restart length (ignored by minres)
    :param report: optional dict accumulating "solves", "iterations" and
        the operator applies ("matmats": lane-stack applies, the new
        columns' one included; "matvecs": GMRES lanes' single applies)
    :returns: :class:`KrylovStepResult`; new vectors are zero rows where
        linear dependence was detected.
    """
    M, n = V.shape
    nBlock = seeds.shape[0]
    require_true_fp32(V)
    kwargs = dict(rtol=rtol, atol=0.0, maxiter=maxiter, precond=precond)
    if solver == "minres":
        res = minres_batch(op, seeds, [sigma] * nBlock, **kwargs)
    elif solver == "gmres":
        res = gmres_batch(op, seeds, [sigma] * nBlock, restart=restart,
                          **kwargs)
    else:
        raise ValueError(f"unknown solver {solver!r}")
    nrm = torch.linalg.vector_norm(res.x, dim=1, keepdim=True)
    X = (res.x / torch.where(nrm > 0, nrm, torch.ones_like(nrm))).to(V.dtype)

    # CGS2 against the valid basis rows, all block vectors in one product
    # per pass, then their mutual orthonormalization from the Gram matrix
    Vv = V[:nvec]
    for _ in range(2):
        X = X - (Vv.T @ (Vv.conj() @ X.T)).T
    G = (X.conj() @ X.T).cpu().numpy()
    L, oks = _masked_cholesky(G, lindep)

    # W = L^{-1} X by forward substitution; lindep rows are zero
    Lt = torch.as_tensor(L, device=V.device)
    rows = []
    for i in range(nBlock):
        w = X[i]
        for k in range(i):
            w = w - Lt[i, k] * rows[k]
        rows.append(w / Lt[i, i] if oks[i] else torch.zeros_like(w))
    newV = torch.stack(rows)

    # the accepted rows go after the valid ones; the new S/H columns
    # against that extended basis, both families in ONE product:
    # s_cols[i, j] = <v_j | w_i>, h_cols[i, j] = <v_j | H w_i>
    Vwork = V.clone()
    Vwork[nvec:nvec + int(oks.sum())] = newV[torch.as_tensor(oks)]
    AV = op.matvec_lanes(newV).to(V.dtype)
    C = (Vwork.conj() @ torch.cat([newV, AV]).T).cpu().numpy()  # (M, 2nBlock)

    if report is not None:
        applies = "matmats" if solver == "minres" else "matvecs"
        for key, val in (("solves", nBlock),
                         ("iterations", int(np.sum(res.iterations))),
                         (applies, res.matvecs)):
            report[key] = report.get(key, 0) + val
        report["matmats"] = report.get("matmats", 0) + 1
    return KrylovStepResult(newV, C[:, nBlock:].T, C[:, :nBlock].T,
                            np.asarray(res.resnorm, np.float64), ~oks)
