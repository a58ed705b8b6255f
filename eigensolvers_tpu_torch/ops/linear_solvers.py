"""Krylov linear solver for the shifted systems (sigma*I - H) x = b.

:func:`minres` — Hermitian (possibly indefinite) shifted solves, the default
inner solver of inexact Lanczos (the role of the reference's scipy
``minres``, reference: numpyVector.py:161-171).  It is the JAX package's
``_minres_fixed`` recurrence as a Python loop: the vectors stay on the
operator's device, the scalar recurrence runs on the host, and each
iteration reads two scalars back from the device.

Optional Jacobi preconditioning (``precond="jacobi"``): absolute-value
Jacobi M = 1/|diag(sigma*I - H)| (M must be SPD for an indefinite system),
built when the operator exposes ``diagonal()``.

Stopping criterion: ||r|| <= max(rtol*||b||, atol).  The outer eigensolvers
depend on *inexactness semantics* (loose inner tolerances), not on bitwise
solver equality with SciPy.

Batched solves (``minres_batch``), GMRES and the exact dense solves are not
ported yet (ROADMAP Queue A).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .operators import AbstractOperator


class SolveResult(NamedTuple):
    x: torch.Tensor
    resnorm: float            # final residual estimate
    iterations: int           # matvec-level iteration count
    converged: bool
    matvecs: int              # operator applications, residual checks incl.


def _vdot_re(a, b):
    return torch.vdot(a, b).real


def _shifted_matvec(op: AbstractOperator, sigma, gf_sign):
    """A(x) = gf_sign * (sigma*x - H x);  gf_sign=+1 is the Green's function
    (sigma - H), -1 the reverse (H - sigma) (reference: numpyVector.py:151-154)."""
    def matvec(x):
        y = sigma * x - op.matvec(x)
        return y if gf_sign == 1.0 else gf_sign * y
    return matvec


# ----------------------------------------------------------------------------
# MINRES (Paige & Saunders) — Hermitian, possibly indefinite
# ----------------------------------------------------------------------------
def _minres_fixed(matvec, b, x0, rtol, atol, maxiter, psolve=None):
    """MINRES (Paige & Saunders); with ``psolve`` (an SPD M applied as a
    callable) this is standard preconditioned MINRES: the Lanczos vectors are
    M-orthogonal and phibar tracks the M^{-1}-norm of the residual.  Since
    that norm can stop short of the true-2-norm contract
    ||r|| <= max(rtol*||b||, atol), preconditioned runs add warm-restart
    continuation rounds (tightening the inner tolerance 10x per round) until
    the true residual satisfies it or the iteration budget is spent.

    The vectors stay on the device; the scalar recurrence (plane rotations,
    stopping test) runs on the host in double precision, as scipy's minres
    does.  Each iteration reads its two new Lanczos scalars (alfa, beta)
    back in one transfer — the one host read per iteration."""
    dtype = torch.promote_types(b.dtype, x0.dtype)
    b = b.to(dtype)
    x0 = x0.to(dtype)
    eps = torch.finfo(torch.empty((), dtype=dtype).real.dtype).eps

    preconditioned = psolve is not None
    if psolve is None:
        psolve = lambda r: r          # noqa: E731
    nmv = 0

    def core(x, tol_m, itn):
        """One MINRES sweep from x with M-norm tolerance tol_m; the
        iteration counter starts at itn and is bounded by maxiter.  Returns
        (x, phibar, itn)."""
        nonlocal nmv
        r1 = b - matvec(x)
        nmv += 1
        y = psolve(r1)
        beta = math.sqrt(max(_vdot_re(r1, y).item(), 0.0))
        r2 = r1
        w = torch.zeros_like(b)
        w2 = torch.zeros_like(b)
        oldb, dbar, epsln, phibar, cs, sn = 0.0, 0.0, 0.0, beta, -1.0, 0.0
        while itn < maxiter and phibar > tol_m and beta > 0:
            itn += 1
            v = (1.0 / beta) * y
            y = matvec(v)
            nmv += 1
            # The b_{k-1} correction applies from each sweep's SECOND
            # iteration on (oldb is exactly 0 only on a sweep's first step)
            # — gating on the global itn would corrupt the first step of
            # warm-restart sweeps.
            gate = 1.0 if oldb > 0 else 0.0
            coef = gate * -(beta / (oldb if oldb > 0 else 1.0))
            y = torch.add(y, r1, alpha=coef)
            alfa_t = _vdot_re(v, y)
            y = torch.addcmul(y, alfa_t.to(y.dtype), r2, value=-1.0 / beta)
            r1, r2 = r2, y
            my = psolve(y)
            alfa, bb = torch.stack([alfa_t, _vdot_re(y, my)]).tolist()
            oldb = beta
            beta = math.sqrt(max(bb, 0.0))

            # Plane rotations (QR of the tridiagonal)
            oldeps = epsln
            delta = cs * dbar + sn * alfa
            gbar = sn * dbar - cs * alfa
            epsln = sn * beta
            dbar = -cs * beta
            gamma = max(math.sqrt(gbar * gbar + beta * beta), eps)
            cs = gbar / gamma
            sn = beta / gamma
            phi = cs * phibar
            phibar = sn * phibar

            w1 = w2
            w2 = w
            w = torch.add(v, w1, alpha=-oldeps).add_(w2, alpha=-delta)
            w = w.mul_(1.0 / gamma)
            x = torch.add(x, w, alpha=phi)
            y = my
        return x, phibar, itn

    def norm(r):
        return torch.linalg.vector_norm(r).item()

    tol_abs = max(rtol * math.sqrt(max(_vdot_re(b, psolve(b)).item(), 0.0)),
                  atol)
    x, phibar, itn = core(x0, tol_abs, 0)
    if not preconditioned:
        return SolveResult(x, phibar, itn, phibar <= tol_abs, nmv)

    # Continuation rounds against the true-2-norm contract.
    tol_true = max(rtol * norm(b), atol)
    rnorm = norm(b - matvec(x))
    nmv += 1
    tol_m = tol_abs
    rounds = 0
    # rounds cap guards against Lanczos breakdown (beta = 0) stagnation
    while rnorm > tol_true and itn < maxiter and rounds < 8:
        tol_m = 0.1 * tol_m
        x, _, itn = core(x, tol_m, itn)
        rnorm = norm(b - matvec(x))
        nmv += 1
        rounds += 1
    return SolveResult(x, rnorm, itn, rnorm <= tol_true, nmv)


# ----------------------------------------------------------------------------
# Jacobi preconditioner for the shifted system A = gf_sign*(sigma*I - H)
# ----------------------------------------------------------------------------
def _jacobi_spd(op, sigma, gf_sign):
    """SPD (absolute-value) Jacobi for MINRES: M = 1/max(|diag(A)|, floor).
    Returns None when the operator has no cheap diagonal."""
    d = op.diagonal()
    if d is None:
        return None
    dA = torch.abs(gf_sign * (sigma - d))
    floor = 1e-8 * torch.clamp_min(torch.max(dA), 1.0)
    m = 1.0 / torch.maximum(dA, floor)
    return lambda r: (m * r.reshape(-1)).reshape(r.shape)


def _resolve_precond(precond, op, sigma, gf_sign):
    if precond in (None, "none"):
        return None
    if precond != "jacobi":
        raise ValueError(
            f"unknown preconditioner {precond!r}; available: jacobi")
    return _jacobi_spd(op, sigma, gf_sign)


def minres(op, b, sigma, x0=None, rtol=1e-4, atol=0.0, maxiter=1000,
           reverseGF=False, precond=None) -> SolveResult:
    """Hermitian shifted solve (sigma*I - H) x = b via MINRES
    (``precond="jacobi"`` for absolute-value Jacobi preconditioning)."""
    gf_sign = -1.0 if reverseGF else 1.0
    psolve = _resolve_precond(precond, op, sigma, gf_sign)
    x0 = torch.zeros_like(b) if x0 is None else x0
    return _minres_fixed(_shifted_matvec(op, sigma, gf_sign), b, x0, rtol,
                         atol, maxiter, psolve=psolve)
