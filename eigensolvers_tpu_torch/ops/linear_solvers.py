"""Linear solvers for the shifted systems (sigma*I - H) x = b.

* :func:`minres` — Hermitian (possibly indefinite) shifted solves, the
  default inner solver of inexact Lanczos (the role of the reference's
  scipy ``minres``, reference: numpyVector.py:161-171).  It is the JAX
  package's ``_minres_fixed`` recurrence as a Python loop: the vectors stay
  on the operator's device, the scalar recurrence runs on the host, and
  each iteration reads two scalars back from the device.
* :func:`minres_batch` — the same recurrence over a lane stack (m, n), one
  shift per lane: one multi-vector operator apply per iteration for all
  lanes (``op.matvec_lanes``), every lane's scalars in one read.
* :func:`gmres`, :func:`gmres_batch` — restarted GMRES for general and
  complex shifts (the role of the reference's ``gcrotmk``): CGS2 Arnoldi on
  the device, the Givens QR and back substitution on the host.
* :func:`solve_exact`, :func:`solve_exact_batch` — dense direct solves (the
  reference's misnamed ``"pardiso"`` option), one factorisation per
  distinct shift.

Optional Jacobi preconditioning (``precond="jacobi"``), built when the
operator exposes ``diagonal()``: absolute-value Jacobi
M = 1/|diag(sigma*I - H)| for MINRES (M must be SPD for an indefinite
system), plain right Jacobi for GMRES.

Stopping criterion: ||r|| <= max(rtol*||b||, atol).  The outer eigensolvers
depend on *inexactness semantics* (loose inner tolerances), not on bitwise
solver equality with SciPy.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .operators import AbstractOperator, PaddedOperator, require_true_fp32


class SolveResult(NamedTuple):
    """One solve's result.  A batched solve holds x (m, n) and per-lane
    numpy arrays in ``resnorm``, ``iterations`` and ``converged``; its
    ``matvecs`` counts applies of the whole lane stack for
    :func:`minres_batch` and single-vector applies for
    :func:`gmres_batch`."""
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
# MINRES over a lane stack
# ----------------------------------------------------------------------------
_RESID, _ITER, _DONE = 0, 1, 2      # lane phases of _minres_lanes


def _rowdot_re(a, b):
    """Re <a_k | b_k> for each row k."""
    return torch.linalg.vecdot(a, b).real


def _minres_lanes(apply, b, x, rtol, atol, maxiter, psolve=None):
    """:func:`_minres_fixed` on every row of b (m, n), each lane on its own
    trajectory: lane k ends with the x, residual, iteration count and
    convergence flag that the single recurrence gives on row k alone
    (sweeps, the ``oldb > 0`` gate, the ``beta > 0`` stop and the
    preconditioned continuation rounds are all per lane).

    Every pass applies the operator ONCE to the whole stack (``apply``):
    iterating lanes apply it to their Lanczos vector v, the other live lanes
    to their iterate x, for the residual b - A x that starts a sweep or,
    with a preconditioner, checks the true 2-norm contract after one.  The
    check's residual is the next sweep's r1, so a continuation costs one
    apply, not two.  A finished lane is frozen: no vector of it is written
    again.  Each pass reads every lane's new scalars (alfa, beta and the
    residual dots) back in ONE transfer; the rotations run on the host in
    double precision, as in :func:`_minres_fixed`, and the coefficients of
    this pass's updates and of the next pass go back in one small copy.
    Returns (x, resnorm, itn, converged,
    applies) with per-lane numpy arrays."""
    m = b.shape[0]
    dev = b.device
    rdtype = torch.empty((), dtype=b.dtype).real.dtype
    eps = torch.finfo(rdtype).eps
    preconditioned = psolve is not None
    if psolve is None:
        psolve = lambda r: r          # noqa: E731

    t = torch.stack([_rowdot_re(b, psolve(b)),
                     torch.linalg.vector_norm(b, dim=1)]).cpu().double()
    tol_abs = np.maximum(rtol * np.sqrt(np.maximum(t[0].numpy(), 0.0)), atol)
    tol_true = np.maximum(rtol * t[1].numpy(), atol)

    beta, oldb, dbar, epsln, phibar, sn = (np.zeros(m) for _ in range(6))
    cs = -np.ones(m)
    itn = np.zeros(m, np.int64)
    rounds = np.zeros(m, np.int64)
    tol_m = tol_abs.copy()
    resnorm = np.zeros(m)
    started = np.zeros(m, bool)
    phase = np.full(m, _RESID)
    r1 = r2 = y = w = w2 = torch.zeros_like(b)
    nxt = None          # this pass's 1/beta and b_{k-1} coefficients
    applies = 0

    def upload(*rows):
        """Per-lane host values as (len(rows), m, 1) device columns."""
        return torch.as_tensor(np.stack(rows), dtype=rdtype,
                               device=dev)[:, :, None]

    def select(mask, new, old):
        return new if mask.all() else torch.where(
            torch.as_tensor(mask, device=dev)[:, None], new, old)

    def sweep_runs(k):
        return itn[k] < maxiter and phibar[k] > tol_m[k] and beta[k] > 0

    def finish(k, value):
        phase[k] = _DONE
        resnorm[k] = value

    while True:
        it = phase == _ITER
        res = phase == _RESID
        if not (it.any() or res.any()):
            break
        if it.any():
            v = y * nxt[0]
        W = apply(select(it, v, x) if it.any() else x)
        applies += 1
        reads = []
        if it.any():
            Yn = W + nxt[1] * r1
            alfa_t = _rowdot_re(v, Yn)
            Yn = Yn - (alfa_t * nxt[0, :, 0])[:, None] * r2
            my = psolve(Yn)
            reads += [alfa_t, _rowdot_re(Yn, my)]
        if res.any():
            R = b - W
            myR = psolve(R)
            reads += [_rowdot_re(R, R), _rowdot_re(R, myR)]
        got = list(torch.stack(reads).cpu().double().numpy())

        # -- host: plane rotations (QR of the tridiagonal) of iterating lanes
        phi, oldeps, delta, inv_gamma = (np.zeros(m) for _ in range(4))
        if it.any():
            alfa, bb = got[0], got[1]
            got = got[2:]
        for k in np.nonzero(it)[0]:
            itn[k] += 1
            oldb[k] = beta[k]
            beta[k] = math.sqrt(max(bb[k], 0.0))
            oldeps[k] = epsln[k]
            delta[k] = cs[k] * dbar[k] + sn[k] * alfa[k]
            gbar = sn[k] * dbar[k] - cs[k] * alfa[k]
            epsln[k] = sn[k] * beta[k]
            dbar[k] = -cs[k] * beta[k]
            gamma = max(math.sqrt(gbar * gbar + beta[k] * beta[k]), eps)
            cs[k] = gbar / gamma
            sn[k] = beta[k] / gamma
            phi[k] = cs[k] * phibar[k]
            phibar[k] = sn[k] * phibar[k]
            inv_gamma[k] = 1.0 / gamma
            if not sweep_runs(k):
                if preconditioned:
                    phase[k] = _RESID
                else:
                    finish(k, phibar[k])

        # -- host: sweep starts and true-residual checks of residual lanes
        start = np.zeros(m, bool)
        for k in np.nonzero(res)[0]:
            rn = math.sqrt(max(got[0][k], 0.0))
            while True:
                if started[k]:
                    # rounds cap guards against Lanczos breakdown (beta = 0)
                    # stagnation
                    if not (rn > tol_true[k] and itn[k] < maxiter
                            and rounds[k] < 8):
                        finish(k, rn)
                        break
                    tol_m[k] *= 0.1
                    rounds[k] += 1
                started[k] = start[k] = True
                beta[k] = math.sqrt(max(got[1][k], 0.0))
                oldb[k] = dbar[k] = epsln[k] = sn[k] = 0.0
                cs[k] = -1.0
                phibar[k] = beta[k]
                if sweep_runs(k):
                    phase[k] = _ITER
                    break
                if not preconditioned:
                    finish(k, phibar[k])
                    break
                # an empty sweep leaves x unchanged: its check reuses rn

        # -- device: the vector updates, and the next pass's 1/beta and
        # b_{k-1} correction (gated on oldb > 0: it applies from each sweep's
        # SECOND iteration on, as oldb is exactly 0 only on a sweep's first)
        nit = phase == _ITER
        c = upload(phi, -oldeps, -delta, inv_gamma,
                   np.where(nit, 1.0 / np.where(nit, beta, 1.0), 0.0),
                   np.where(oldb > 0, -(beta / np.where(oldb > 0, oldb, 1.0)),
                            0.0))
        nxt = c[4:]
        if it.any():
            w_new = (v + c[1] * w2 + c[2] * w) * c[3]
            x = select(it, x + c[0] * w_new, x)
            w2, w = select(it, w, w2), select(it, w_new, w)
            r1, r2 = select(it, r2, r1), select(it, Yn, r2)
            y = select(it, my, y)
        if start.any():
            zero = torch.zeros_like(b)
            r1, r2 = select(start, R, r1), select(start, R, r2)
            y = select(start, myR, y)
            w, w2 = select(start, zero, w), select(start, zero, w2)

    conv = resnorm <= (tol_true if preconditioned else tol_abs)
    return x, resnorm, itn, conv, applies


# ----------------------------------------------------------------------------
# Restarted GMRES — general (non-Hermitian / complex-shifted) systems
# ----------------------------------------------------------------------------
def _gmres_fixed(matvec, b, x0, rtol, atol, restart, maxiter, psolve=None):
    """The JAX package's restarted GMRES: each cycle builds a
    ``restart``-step Arnoldi basis with CGS2 reorthogonalisation (stacked
    products on the device) and keeps the Hessenberg QR by Givens
    rotations, which run with the back substitution on the host in double
    precision; each Arnoldi step reads its new column back in one transfer.
    After a happy breakdown the rest of the cycle's columns would be zero
    and contribute nothing, so the cycle stops there.  ``iterations``
    counts ``restart`` per cycle, as the JAX package does; ``matvecs``
    counts the applies made."""
    if psolve is None:
        psolve = lambda z: z          # noqa: E731
    dtype = torch.promote_types(b.dtype, x0.dtype)
    b = b.to(dtype)
    x = x0.to(dtype)
    require_true_fp32(b)
    n = b.shape[0]
    tiny = torch.finfo(torch.empty((), dtype=dtype).real.dtype).tiny
    hdtype = np.complex128 if dtype.is_complex else np.float64

    def norm(r):
        return torch.linalg.vector_norm(r).item()

    tol_abs = max(rtol * norm(b), atol)
    r = b - matvec(x)
    nmv = 1
    rnorm = norm(r)
    ncyc = 0
    while ncyc < -(-maxiter // restart) and rnorm > tol_abs:
        V = torch.zeros((restart + 1, n), dtype=dtype, device=b.device)
        V[0] = r / (rnorm if rnorm > tiny else 1.0)
        R = np.zeros((restart + 1, restart), hdtype)  # upper-triangular factor
        givens = np.zeros((restart, 2), hdtype)       # (c_j, s_j) per column
        g = np.zeros(restart + 1, hdtype)             # rotated rhs beta*e1
        g[0] = rnorm
        for j in range(restart):
            w = matvec(psolve(V[j]))
            nmv += 1
            Vj = V[:j + 1]
            h1 = Vj.conj() @ w
            w = w - Vj.T @ h1
            h2 = Vj.conj() @ w                      # second CGS pass
            w = w - Vj.T @ h2
            hnext_t = torch.linalg.vector_norm(w)
            h = np.zeros(restart + 1, hdtype)
            h[:j + 2] = torch.cat([h1 + h2, hnext_t[None].to(dtype)]
                                  ).cpu().numpy()
            hnext = float(np.real(h[j + 1]))
            ok = hnext > tiny
            V[j + 1] = w / hnext if ok else 0.0
            for i in range(j):       # the previous rotations, on the column
                c, s = givens[i]
                h[i], h[i + 1] = (np.conj(c) * h[i] + np.conj(s) * h[i + 1],
                                  -s * h[i] + c * h[i + 1])
            denom = math.sqrt(abs(h[j]) ** 2 + abs(h[j + 1]) ** 2)
            safe = denom > tiny
            cj = h[j] / denom if safe else 1.0     # new rotation zeroing h[j+1]
            sj = h[j + 1] / denom if safe else 0.0
            givens[j] = cj, sj
            h[j], h[j + 1] = denom, 0.0
            g[j], g[j + 1] = np.conj(cj) * g[j], -sj * g[j]
            R[:, j] = h
            if not ok:
                break
        # back substitution on the triangular R (zero diagonals from a happy
        # breakdown contribute y_j = 0)
        y = np.zeros(restart, hdtype)
        for i in reversed(range(restart)):
            s = g[i] - R[i, i + 1:restart] @ y[i + 1:]
            y[i] = s / R[i, i] if abs(R[i, i]) > tiny else 0.0
        y_t = torch.as_tensor(y, device=b.device).to(dtype)
        x = x + psolve(V[:restart].T @ y_t)
        r = b - matvec(x)
        nmv += 1
        rnorm = norm(r)
        ncyc += 1
    return SolveResult(x, rnorm, ncyc * restart, rnorm <= tol_abs, nmv)


# ----------------------------------------------------------------------------
# Jacobi preconditioners for the shifted system A = gf_sign*(sigma*I - H)
# ----------------------------------------------------------------------------
def _jacobi_spd(op, sigma, gf_sign):
    """SPD (absolute-value) Jacobi for MINRES: M = 1/max(|diag(A)|, floor).
    ``sigma`` is a scalar, or an (m, 1) column of per-lane shifts that
    gives each row of a lane stack its own M.  Returns None when the
    operator has no cheap diagonal."""
    d = op.diagonal()
    if d is None:
        return None
    dA = torch.abs(gf_sign * (sigma - d))
    floor = 1e-8 * torch.clamp_min(dA.amax(dim=-1, keepdim=True), 1.0)
    m = 1.0 / torch.maximum(dA, floor)
    return lambda r: (m * r.reshape(m.shape)).reshape(r.shape)


def _jacobi_right(op, sigma, gf_sign, dtype):
    """Right Jacobi for GMRES: z = r / diag(A), guarded near diag(A) = 0
    (entries within floor of zero fall back to identity)."""
    d = op.diagonal()
    if d is None:
        return None
    dA = (gf_sign * (sigma - d.to(dtype))).to(dtype)
    mag = torch.abs(dA)
    floor = 1e-8 * torch.clamp_min(torch.max(mag), 1.0)
    safe = torch.where(mag > floor, dA, torch.ones_like(dA))
    return lambda r: (r.reshape(-1) / safe).reshape(r.shape)


def _resolve_precond(precond, kind, op, sigma, gf_sign, dtype=None):
    if precond in (None, "none"):
        return None
    if precond != "jacobi":
        raise ValueError(
            f"unknown preconditioner {precond!r}; available: jacobi")
    if kind == "minres":
        return _jacobi_spd(op, sigma, gf_sign)
    return _jacobi_right(op, sigma, gf_sign, dtype)


# ----------------------------------------------------------------------------
# public entry points
# ----------------------------------------------------------------------------
def minres(op, b, sigma, x0=None, rtol=1e-4, atol=0.0, maxiter=1000,
           reverseGF=False, precond=None) -> SolveResult:
    """Hermitian shifted solve (sigma*I - H) x = b via MINRES
    (``precond="jacobi"`` for absolute-value Jacobi preconditioning)."""
    gf_sign = -1.0 if reverseGF else 1.0
    psolve = _resolve_precond(precond, "minres", op, sigma, gf_sign)
    x0 = torch.zeros_like(b) if x0 is None else x0
    return _minres_fixed(_shifted_matvec(op, sigma, gf_sign), b, x0, rtol,
                         atol, maxiter, psolve=psolve)


def minres_batch(op, bs, sigmas, x0s=None, rtol=1e-4, atol=0.0,
                 maxiter=1000, reverseGF=False, precond=None) -> SolveResult:
    """Batched MINRES over the rows of the lane stack ``bs`` (m, n): lane k
    solves with the real shift ``sigmas[k]`` from the warm start ``x0s[k]``
    (the JAX package's ``vmap`` of ``_minres_fixed``; Jacobi M is built per
    lane from its shift).  Each iteration applies the operator once to all
    lanes (``op.matvec_lanes``); ``matvecs`` counts those applies."""
    dtype = bs.dtype if x0s is None else torch.promote_types(bs.dtype,
                                                             x0s.dtype)
    b = bs.to(dtype)
    x = torch.zeros_like(b) if x0s is None else x0s.to(dtype)
    gf_sign = -1.0 if reverseGF else 1.0
    sig = torch.as_tensor(np.asarray(sigmas, np.float64).reshape(-1, 1),
                          dtype=torch.empty((), dtype=dtype).real.dtype,
                          device=b.device)
    psolve = _resolve_precond(precond, "minres", op, sig, gf_sign)

    def apply(U):
        Y = sig * U - op.matvec_lanes(U)
        return Y if gf_sign == 1.0 else gf_sign * Y

    return SolveResult(*_minres_lanes(apply, b, x, rtol, atol, maxiter,
                                      psolve=psolve))


def gmres(op, b, sigma, x0=None, rtol=1e-4, atol=0.0, restart=30,
          maxiter=1000, reverseGF=False, precond=None) -> SolveResult:
    """General shifted solve via restarted GMRES (handles complex sigma;
    ``precond="jacobi"`` for right Jacobi preconditioning)."""
    sigma = complex(sigma) if np.iscomplexobj(sigma) else float(sigma)
    dtype = torch.promote_types(b.dtype, op.dtype)
    if isinstance(sigma, complex):
        dtype = torch.promote_types(dtype, torch.complex64)
    b = b.to(dtype)
    x0 = torch.zeros_like(b) if x0 is None else x0.to(dtype)
    gf_sign = -1.0 if reverseGF else 1.0
    psolve = _resolve_precond(precond, "gmres", op, sigma, gf_sign, dtype)
    return _gmres_fixed(_shifted_matvec(op, sigma, gf_sign), b, x0, rtol,
                        atol, restart, maxiter, psolve=psolve)


def gmres_batch(op, bs, sigmas, x0s=None, rtol=1e-4, atol=0.0, restart=30,
                maxiter=1000, reverseGF=False, precond=None) -> SolveResult:
    """GMRES on each row of the lane stack ``bs`` with its own shift, one
    lane after another (the lanes are independent)."""
    sig = np.asarray(sigmas).reshape(-1)
    outs = [gmres(op, bs[k], sig[k], x0=None if x0s is None else x0s[k],
                  rtol=rtol, atol=atol, restart=restart, maxiter=maxiter,
                  reverseGF=reverseGF, precond=precond)
            for k in range(bs.shape[0])]
    return SolveResult(torch.stack([o.x for o in outs]),
                       np.array([o.resnorm for o in outs]),
                       np.array([o.iterations for o in outs]),
                       np.array([o.converged for o in outs]),
                       sum(o.matvecs for o in outs))


# ----------------------------------------------------------------------------
# Exact dense solves
# ----------------------------------------------------------------------------
def _sigma_array(sigma, *operand_dtypes) -> torch.Tensor:
    """Shift scalar at the precision of the operands: complex64 shifts on
    4-byte data, complex128 on wider; real shifts (and complex ones with a
    zero imaginary part) stay real."""
    width = max(torch.empty((), dtype=d).element_size()
                for d in operand_dtypes)
    if np.iscomplexobj(sigma) and np.imag(sigma) != 0:
        return torch.tensor(complex(sigma), dtype=torch.complex64
                            if width <= 4 else torch.complex128)
    return torch.tensor(float(np.real(sigma)), dtype=torch.float32
                        if width <= 4 else torch.float64)


def _solve_exact_multi(mat, B, sigma, gf_sign):
    """One factorisation of gf_sign*(sigma*I - H), every row of the lane
    stack B (k, n) solved with it."""
    sig = _sigma_array(sigma, mat.dtype, B.dtype)
    dtype = torch.promote_types(torch.promote_types(mat.dtype, B.dtype),
                                sig.dtype)
    eye = torch.eye(mat.shape[0], dtype=dtype, device=mat.device)
    A = gf_sign * (sig.to(mat.device) * eye - mat.to(dtype))
    return torch.linalg.solve(A, B.to(dtype).T).T


def solve_exact(op, b, sigma, reverseGF=False) -> SolveResult:
    """Exact dense solve of (sigma*I - H) x = b; oracle/test path
    (the reference's misnamed "pardiso" option, numpyVector.py:164-171)."""
    return solve_exact_batch(op, b[None, :], [sigma], reverseGF=reverseGF)[0]


def solve_exact_batch(op, B, sigmas, reverseGF=False):
    """Exact dense solves of (sigma_k*I - H) x_k = b_k for a lane stack
    B (nlanes, n).  Lanes sharing a shift share ONE factorisation with a
    multi-RHS solve (FEAST repeats each contour node once per subspace
    vector).  A :class:`PaddedOperator` is solved on its logical block (the
    zero-embedded block makes sigma*I - H_pad singular at sigma == 0) and
    re-padded.  Returns a list of SolveResult."""
    if isinstance(op, PaddedOperator):
        n = op.op.shape[0]
        inner = solve_exact_batch(op.op, B[:, :n], sigmas,
                                  reverseGF=reverseGF)
        return [r._replace(x=torch.nn.functional.pad(r.x, (0, op.n_pad - n)))
                for r in inner]
    sig = np.asarray(sigmas).ravel()
    mat = op.to_dense()
    gf = -1.0 if reverseGF else 1.0
    xs = [None] * len(sig)
    for s in sorted(set(sig.tolist()), key=lambda z: (np.real(z), np.imag(z))):
        lanes = np.nonzero(sig == s)[0]
        X = _solve_exact_multi(mat, B[torch.as_tensor(lanes, device=B.device)],
                               s, gf)
        for j, lane in enumerate(lanes):
            xs[int(lane)] = X[j]
    return [SolveResult(x, 0.0, 1, True, 0) for x in xs]
