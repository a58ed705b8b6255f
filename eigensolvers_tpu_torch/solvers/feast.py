"""FEAST contour-integration eigensolver.

Computes all eigenpairs inside [eMin, eMax] by applying the spectral
projector P = (1/2πi) ∮ (zI - H)^{-1} dz, evaluated by quadrature over a
half-ellipse contour, to a subspace of guess vectors, followed by
Rayleigh-Ritz in the filtered subspace.

Parity with the JAX package's ``solvers/feast.py`` (reference feast.py:126-244;
Polizzi PRB 79, 115112 (2009); Baiardi, Kelemen, Reiher JCTC 18, 1415 (2021)):
  * contour points θ_k = -(π/2)(g_k - 1), z_k = (eMin+eMax)/2 +
    r(cosθ_k + e·i·sinθ_k) with ellipse factor e;
  * half-contour quadrature (positiveHalf) valid for Hermitian H;
  * exact-addition backends: one complex solve per node,
    Qquad_k = Re[-½ w_k r (e·cosθ + i·sinθ) G(z)Y];
  * inexact-addition (compressed) backends: two solves at z and z̄ combined
    with conjugate coefficients (Polizzi eq. 12);
  * residual over [eMin, eMax] with subspace-shrink matching.

The quadrature × subspace double loop (nc/2 × m0 independent shifted
solves per FEAST iteration) runs as ONE lane stack through the backend's
``solveBatchSplit`` / ``solveBatch``: every MINRES pass applies H once to
all 2·nk·m0 real lanes (one B3 launch on a block-sparse H).  On a real
operator the fused loop (:mod:`.fast_feast`) is the default path.
"""

from __future__ import annotations

import math
import time
import warnings
from typing import List

import numpy as np
import torch

from ..vectors.abstract import AbstractVector
from ..utils.status import feast_status
from ..utils.subspace import (
    basisTransformation,
    diagonalizeHamiltonian,
    eigenvalueResidual,
    lowdinOrthoMatrix,
)
from ..utils.quadrature import quadraturePointsWeights
from ..utils.reporting import FeastReporter
from ..utils.profiling import PhaseTimer, spans, to_host


def _node_optype(z):
    """Operator type for one quadrature node: real z keeps the Hermitian
    structure; complex z is dispatched as "gen" (the reference disabled its
    complex-symmetric solver for stability, reference: feast.py:84-87).  The
    production path (:func:`_use_split_complex`) exploits the
    complex-symmetric structure of (zI - H) through the J-symmetrized 2x2
    real-block MINRES instead."""
    if abs(z.imag) < 1e-15:
        return "her", z.real
    return "gen", z


def calculateQuadrature(Amat, guess_b, z, radius, angle, weight,
                        contourEllipseFactor):
    """One quadrature term Qquad_k for one subspace vector (Hermitian A),
    sequential path (reference: feast.py:45-103)."""
    b = guess_b
    typeClass = b.__class__
    opType, z = _node_optype(z)

    if b.hasExactAddition:
        Qe = typeClass.solve(Amat, b, z, opType=opType)
        mult = -0.50 * weight * radius * (
            contourEllipseFactor * math.cos(angle) + math.sin(angle) * 1j)
        return typeClass.real(mult * Qe)
    # Polizzi (12): pair of solves at z and conj(z)
    mult = -0.25 * weight * radius
    part1 = typeClass.solve(Amat, b, z, opType=opType)
    part2 = typeClass.solve(Amat, b, np.conj(z), opType=opType)
    c1 = mult * (contourEllipseFactor * math.cos(angle) + math.sin(angle) * 1j)
    c2 = mult * (contourEllipseFactor * math.cos(angle) - math.sin(angle) * 1j)
    return typeClass.linearCombination([part1, part2], [c1, c2])


def updateQ(Q, im0, Qquad_k, k):
    """Accumulate the k-th quadrature term into Q[im0]
    (reference: feast.py:105-121)."""
    typeClass = Qquad_k.__class__
    if k == 0:
        Q[im0] = Qquad_k
    else:
        Q[im0] = typeClass.linearCombination([Q[im0], Qquad_k], [1.0, 1.0])
    return Q


def _contour(eMin, eMax, nc, quad, contourEllipseFactor):
    """Quadrature nodes on the half-ellipse: returns (gk, wk, thetas, zs)."""
    gk, wk = quadraturePointsWeights(nc, quad, positiveHalf=True)
    eRadius = (eMax - eMin) * 0.5
    thetas = -(np.pi * 0.5) * (gk - 1.0)
    zs = (eMin + eMax) * 0.5 + eRadius * (
        np.cos(thetas) + contourEllipseFactor * 1.0j * np.sin(thetas))
    return gk, wk, thetas, zs


def _is_complex_dtype(dtype) -> bool:
    """A torch or numpy dtype (or anything numpy reads as one) is complex."""
    if isinstance(dtype, torch.dtype):
        return dtype.is_complex
    return np.iscomplexobj(np.zeros((), dtype=np.dtype(dtype)))


def _use_split_complex(A, Y):
    """Split-complex (all-real 2x2 block) solves take the complex contour
    shifts whenever the operator and the subspace are real and the backend
    implements them.  The J-symmetrized real-block MINRES is the better
    algorithm for a complex shift on a real symmetric operator
    (conditioning ~|sigma-lam|, short recurrence, no restart stagnation);
    restarted GMRES on the complex system stagnates at contour nodes near
    the real axis.  Override via linearSystemArgs["splitComplex"]; exact
    (direct) solves bypass it."""
    typeClass = type(Y[0])
    if not hasattr(typeClass, "solveBatchSplit"):
        return False
    if any(_is_complex_dtype(y.dtype) for y in Y):
        return False
    # the J-symmetrization requires a REAL symmetric operator
    a_dtype = getattr(A, "dtype", None)
    if a_dtype is None or _is_complex_dtype(a_dtype):
        return False
    opts = Y[0].options.get("linearSystemArgs", {})
    if opts.get("linearSolver") in ("exact", "pardiso"):
        return False  # oracle path: exact complex direct solves
    forced = opts.get("splitComplex")
    if forced is not None:
        return bool(forced)
    return True


def _ritz_warm_starts(Y, zs, ritz_ev, split: bool):
    """Warm starts for the FEAST lane stack from the previous iteration's
    Ritz values: x0_{k,i} = Y[i] / (z_k - ev_i) — the exact solution of
    (z_k I - A) x = Y[i] when Y[i] IS the eigenvector with eigenvalue ev_i,
    so in later FEAST iterations the guess is nearly exact and the MINRES
    iteration count collapses.  Returns a (nk*m0, 2, n) split stack or an
    (nk*m0, n) complex stack on the vectors' device."""
    m0 = len(Y)
    ev = np.asarray(ritz_ev, np.complex128)
    if len(ev) != m0 or not np.all(np.isfinite(ev)):
        return None
    d = np.asarray(zs)[:, None] - ev[None, :]            # (nk, m0)
    # a real contour node can sit on a Ritz value: zero that lane's guess
    # instead of dividing by ~0
    c = np.zeros_like(d)
    mask = np.abs(d) > 1e-12
    c[mask] = 1.0 / d[mask]
    c = c.reshape(-1)                                    # lane (k, i) order
    Yarr = torch.stack([y.array.reshape(-1) for y in Y])  # (m0, n)
    Yt = Yarr.repeat(len(zs), 1)                         # (nk*m0, n)
    if split:
        cre = torch.as_tensor(c.real, dtype=Yt.dtype, device=Yt.device)
        cim = torch.as_tensor(c.imag, dtype=Yt.dtype, device=Yt.device)
        return torch.stack([Yt * cre[:, None], Yt * cim[:, None]], dim=1)
    ct = torch.as_tensor(c, device=Yt.device)
    return Yt.to(torch.promote_types(Yt.dtype, ct.dtype)) * ct[:, None]


#: warm solves run at least one digit tighter than the configured tolerance
#: (see _warm_rtol_scale)
WARM_RTOL_SCALE = 0.1

#: f32 auto-warm policy: run a COLD solve every this many outer iterations
#: (iterations 0, N, 2N, ... are cold).  Cold solves re-roll the f32 solve
#: noise that Rayleigh-Ritz then averages down, breaking the frozen
#: deterministic-fixed-point floor of always-warm f32 FEAST while keeping
#: the warm speedup on the other iterations (warmStartSolves doc).
COLD_REFRESH_EVERY = 3


def _warm_rtol_scale(Y, residual, eConv):
    """Adaptive solve-tolerance scale for warm-started FEAST iterations.

    A warm-started solve exits with its residual right at the tolerance
    ceiling, in the SAME direction at every contour node, and warm starts
    CORRELATE the solve errors of successive outer iterations, so the
    eigenvalue self-consistency residual under-reports the true error.  The
    inexact-FEAST schedule fixes both: solve each iteration to ~(previous
    residual)/10, bounded above by WARM_RTOL_SCALE x the configured
    tolerance, so the true error falls with the estimate."""
    if residual is None:
        return WARM_RTOL_SCALE
    lin_tol = Y[0].options.get("linearSystemArgs", {}).get("linear_tol", 1e-4)
    target = max(float(residual), float(eConv)) * 0.1
    return float(np.clip(target / max(lin_tol, 1e-300), 1e-6,
                         WARM_RTOL_SCALE))


def _mults(wk, thetas, eRadius, contourEllipseFactor):
    """Quadrature multipliers -0.5 w_k r (e cos θ_k + i sin θ_k)."""
    return np.array([-0.50 * wk[k] * eRadius * (
        contourEllipseFactor * math.cos(thetas[k])
        + math.sin(thetas[k]) * 1j) for k in range(len(wk))])


def _filtered_subspace_batched(A, Y, gk, wk, thetas, zs, eRadius,
                               contourEllipseFactor, ritz_ev=None,
                               report=None, warm_scale=WARM_RTOL_SCALE):
    """Apply the rational filter to all m0 subspace vectors with ALL
    (node, vector) solves in one batched call, and the weighted quadrature
    accumulation as one contraction.  Exact-addition path."""
    typeClass = type(Y[0])
    m0 = len(Y)
    nk = len(gk)
    # batch layout: lane (k, i) solves (z_k I - A) x = Y[i]
    bs = [Y[i] for k in range(nk) for i in range(m0)]
    sigmas = [complex(zs[k]) for k in range(nk) for _ in range(m0)]
    mults = _mults(wk, thetas, eRadius, contourEllipseFactor)

    if _use_split_complex(A, Y):
        x0s = None if ritz_ev is None else \
            _ritz_warm_starts(Y, zs, ritz_ev, split=True)
        sols = typeClass.solveBatchSplit(
            A, bs, sigmas, x0s=x0s,
            rtol_scale=warm_scale if x0s is not None else 1.0,
            report=report)
        return typeClass._accumulate_quadrature_split(sols, mults, m0,
                                                      Y[0].options, ref=Y[0])

    x0s = None if ritz_ev is None else \
        _ritz_warm_starts(Y, zs, ritz_ev, split=False)
    sols = typeClass.solveBatch(
        A, bs, sigmas, x0s=x0s, opType="gen",
        rtol_scale=warm_scale if x0s is not None else 1.0,
        report=report)

    fused = getattr(typeClass, "_accumulate_quadrature", None)
    if fused is not None:
        return fused(sols, mults, m0)

    Q = [None] * m0
    for k in range(nk):
        for i in range(m0):
            Qk = typeClass.real(mults[k] * sols[k * m0 + i])
            Q = updateQ(Q, i, Qk, k)
    return Q


def _feast_loop_fused(A, Y, gk, wk, thetas, zs, eRadius,
                      contourEllipseFactor, eConv, maxit, status, printObj,
                      timer, warmStartSolves, eMin, eMax, cold_every=0):
    """Outer loop over fused iterations
    (solvers/fast_feast.py::feast_filter_program).  Mirrors the generic
    loop body line for line — same status keys, reporter calls, Löwdin /
    shrink / convergence logic (reference: feast.py:185-238) — but carries
    the subspace as a device-resident (m0, n) f64 stack and folds the basis
    rotation, lane tiling, warm starts, contour solves, quadrature
    accumulation and S/H~ assembly into one call per iteration, with one
    host read of (S, H~) beside the lane MINRES's own per-pass reads."""
    from .fast_feast import _mm, feast_filter_program

    typeClass = type(Y[0])
    options = Y[0].options
    opts = options["linearSystemArgs"]
    op = typeClass._as_operator(A, Y[0])
    nk = len(gk)
    N_SUBSPACE = len(Y)
    dev = Y[0].device
    sdtype = Y[0].dtype          # solve dtype (the state's, e.g. f32)
    # carry dtype of the filtered subspace and the Rayleigh-Ritz assembly:
    # f64 whatever the state dtype (mixed precision by design, see
    # feast_filter_program; the generic path gets the same f64 carry
    # through _accumulate_quadrature_split's f64 multipliers)
    adtype = torch.float64

    mults = _mults(wk, thetas, eRadius, contourEllipseFactor)
    sig_re = torch.as_tensor(np.real(zs), device=dev).to(sdtype)
    sig_im = torch.as_tensor(np.imag(zs), device=dev).to(sdtype)
    mult_re = torch.as_tensor(mults.real, dtype=adtype, device=dev)
    mult_im = torch.as_tensor(mults.imag, dtype=adtype, device=dev)

    Ybase = torch.stack([y.array.reshape(-1) for y in Y]).to(adtype)
    C = np.eye(N_SUBSPACE)                             # identity rotation
    ritz = np.zeros(N_SUBSPACE)
    maxiter = int(opts["linearIter"])
    precond = opts.get("preconditioner")
    # lane-level escalation factor for stagnating contour solves (see
    # ops/linear_solvers.py::gmres_splitc_batch)
    escalate = int(opts.get("escalateIter", 3))
    errNC = opts.get("errorOnNonConvergence", True)
    ev = np.full(N_SUBSPACE, np.nan)
    ref_ev = None

    for it in spans("es.feast.outer", range(maxit)):
        status["outerIter"] = it
        status["quadrature"] = nk - 1
        warm = bool(warmStartSolves and it > 0
                    and not (cold_every and it % cold_every == 0))
        scale = _warm_rtol_scale(Y, status.get("residual"), eConv) \
            if warm else 1.0
        with timer.phase("quadrature_solves"):
            Q, S, Hm, res = feast_filter_program(
                op, Ybase, torch.as_tensor(C, dtype=adtype, device=dev),
                sig_re, sig_im, mult_re, mult_im,
                torch.as_tensor(ritz, device=dev).to(sdtype),
                opts["linear_tol"] * scale, opts["linear_atol"] * scale,
                maxiter, precond=precond, warm=warm, escalate=escalate)
            # one host transfer for everything the host-side RR needs (the
            # per-lane results are host arrays already)
            Smat, Hmat = to_host(torch.stack([S, Hm])).numpy()
        nbad = int(res.converged.size - np.count_nonzero(res.converged))
        if nbad:
            msg = (f"Batched split solver: {nbad}/{res.converged.size} lanes "
                   f"did not converge (max residual "
                   f"{float(np.max(res.resnorm)):.3e})")
            if errNC:
                raise RuntimeError(msg)
            warnings.warn(msg)
        typeClass._account(opts, None, "minres", res, res.converged.size)
        status["solverIterations"] = (status.get("solverIterations", 0)
                                      + int(np.sum(res.iterations)))

        printObj.writeFile("iteration", status)
        printObj.writeFile("overlap", Smat)

        with timer.phase("rayleigh_ritz"):
            status, uS = lowdinOrthoMatrix(Smat, status)
            ev, uv = diagonalizeHamiltonian(uS, Hmat, printObj)
            uSH = uS @ uv
            del uv
        # fused basisTransformation: the rotation rides into the next
        # iteration as C (Y_next = uSH^T @ Q)
        Ybase = Q
        C = np.ascontiguousarray(uSH.T)
        ritz = np.asarray(ev, np.float64)

        if it != 0:
            if len(ref_ev) > len(ev):
                # subspace shrank: match reference eigenvalues to nearest
                indices = np.argmin(np.abs(ref_ev[:, None] - ev[None, :]),
                                    axis=0)
                ref_ev = ref_ev[indices]
            elif len(ref_ev) < len(ev):
                raise RuntimeError(f"{ref_ev=} but {ev=}. Enlarged space?")
            residual = eigenvalueResidual(ev, ref_ev, [eMin, eMax])
            status["runTime"] = time.time() - status["startTime"]
            status["residual"] = residual
            printObj.writeFile("summary", ev, residual, status)
            if residual < eConv:
                status["isConverged"] = True
                break

        if N_SUBSPACE != len(ev):
            warnings.warn(
                f"Alert! Got {N_SUBSPACE - len(ev)} dependent vectors")
        N_SUBSPACE = len(ev)
        ref_ev = ev

    # materialize the final rotated subspace (the generic loop's last
    # basisTransformation).  The f64 carry is kept in the returned vectors
    # (as in the generic path, whose accumulation promotes to f64):
    # converged eigenvectors at the carry precision are part of the contract.
    Yfinal = _mm(torch.as_tensor(C, dtype=adtype, device=dev), Ybase)
    Yout = [typeClass(Yfinal[i], options) for i in range(C.shape[0])]
    return ev, Yout, status


def feastDiagonalization(A, Y: List[AbstractVector],
                         nc, quad, eMin, eMax, eConv, maxit,
                         contourEllipseFactor=1.0,
                         writeOut=True, eShift=0.0,
                         convertUnit="au", outFileName=None,
                         summaryFileName=None,
                         status=None,
                         batchQuadratureSolves=True,
                         warmStartSolves=None):
    """FEAST diagonalization of the Hermitian operator ``A`` inside
    [eMin, eMax] (parity: reference feast.py:126-244).

    Input parameters
    ----------------
    A : Hermitian operator (matrix / AbstractOperator / SoP)
    Y : list of guess vectors (subspace dimension m0 = len(Y))
    nc : number of quadrature points (before half-contour filtering)
    quad : quadrature rule — "legendre" (default-recommended), "hermite",
        "trapezoidal"
    eMin, eMax : search window; every eigenvalue inside is computed
    eConv : eigenvalue residual convergence tolerance
        (Σ|E - Eprev| / Σ|E| over the window)
    maxit : maximum FEAST iterations
    contourEllipseFactor : contour shape factor (1.0 circle, <1 ellipse;
        matches Polizzi's Fortran code, needed for oracle tests)
    batchQuadratureSolves : solve all nc/2 × m0 systems as one lane stack
        (exact-addition backends only; compressed backends use the
        sequential 2-solve path)
    warmStartSolves : at outer iterations ≥ 1, seed each (node k, vector i)
        solve with the Ritz approximation Y[i]/(z_k - ev_i) from the previous
        Rayleigh-Ritz step (batched paths only), and tighten the solve
        tolerance adaptively to ~residual/10 (see :func:`_warm_rtol_scale`).
        Default None = AUTO: always-warm for f64 states; for f32, warm with
        a COLD REFRESH every :data:`COLD_REFRESH_EVERY` iterations: at f32,
        always-warm makes the outer iteration a deterministic fixed point
        whose error freezes at the solver's attainable floor while the
        self-consistency estimator sees zero change; the periodic cold
        solve re-rolls that noise so Rayleigh-Ritz averages it down.
        True = always-warm, False = always-cold.

    Returns
    -------
    (ev, Y, status)
    """
    typeClass = type(Y[0])
    N_SUBSPACE = len(Y)
    assert eMax > eMin
    eRadius = (eMax - eMin) * 0.5

    cold_every = 0        # 0 = no periodic cold refresh (always-warm)
    if warmStartSolves is None:
        # auto (see parameter doc): always-warm when the dtype's solve floor
        # is far below the requested tolerances (f64); warm + periodic cold
        # refresh otherwise (f32)
        warmStartSolves = True
        try:
            if torch.finfo(Y[0].dtype).eps > 1e-12:
                cold_every = COLD_REFRESH_EVERY
        except TypeError:
            cold_every = COLD_REFRESH_EVERY

    gk, wk, thetas, zs = _contour(eMin, eMax, nc, quad, contourEllipseFactor)

    status = feast_status(status, Y)
    printObj = FeastReporter(Y, nc, quad, eMin, eMax, eConv, maxit,
                             status.get("writeOut", writeOut), eShift,
                             convertUnit, status, outFileName, summaryFileName)
    printObj.fileHeader()

    ev = np.full(N_SUBSPACE, np.nan)
    ref_ev = None
    timer = PhaseTimer("es.feast", getattr(Y[0], "device", None))

    use_fused = False
    if batchQuadratureSolves and Y[0].hasExactAddition:
        from .fast_feast import fused_eligible
        use_fused = fused_eligible(typeClass, A, Y, _use_split_complex(A, Y))
    if use_fused:
        # fused outer iterations (solvers/fast_feast.py): identical
        # semantics, one host read of the subspace matrices per iteration
        ev, Y, status = _feast_loop_fused(
            A, Y, gk, wk, thetas, zs, eRadius, contourEllipseFactor,
            eConv, maxit, status, printObj, timer, warmStartSolves,
            eMin, eMax, cold_every=cold_every)
        status["timers"] = timer.summary()
        printObj.writeFile("results", ev)
        printObj.fileFooter()
        printObj.close()
        return ev, Y, status

    for it in spans("es.feast.outer", range(maxit)):
        status["outerIter"] = it

        use_batch = (batchQuadratureSolves and Y[0].hasExactAddition
                     and hasattr(typeClass, "solveBatch"))
        with timer.phase("quadrature_solves"):
            if use_batch:
                status["quadrature"] = len(gk) - 1
                report = {}
                warm_it = bool(warmStartSolves and not (
                    cold_every and it % cold_every == 0))
                Q = _filtered_subspace_batched(
                    A, Y, gk, wk, thetas, zs, eRadius, contourEllipseFactor,
                    ritz_ev=ref_ev if warm_it else None,
                    report=report,
                    warm_scale=_warm_rtol_scale(Y, status.get("residual"),
                                                eConv))
                status["solverIterations"] = \
                    status.get("solverIterations", 0) + \
                    report.get("iterations", 0)
            else:
                Q = [np.nan for _ in range(N_SUBSPACE)]
                for k in range(len(gk)):
                    status["quadrature"] = k
                    for im0 in range(N_SUBSPACE):
                        Qquad_k = calculateQuadrature(
                            A, Y[im0], zs[k], eRadius, thetas[k], wk[k],
                            contourEllipseFactor)
                        Q = updateQ(Q, im0, Qquad_k, k)

        # Rayleigh-Ritz in the Löwdin-orthogonalized filtered subspace
        with timer.phase("rayleigh_ritz"):
            Smat = typeClass.overlapMatrix(Q)
            Hmat = typeClass.matrixRepresentation(A, Q)

        printObj.writeFile("iteration", status)
        printObj.writeFile("overlap", Smat)

        status, uS = lowdinOrthoMatrix(Smat, status)
        ev, uv = diagonalizeHamiltonian(uS, Hmat, printObj)
        uSH = uS @ uv
        del uv
        Y = basisTransformation(Q, uSH)
        del Q

        if it != 0:
            if len(ref_ev) > len(ev):
                # subspace shrank: match reference eigenvalues to nearest
                indices = np.argmin(np.abs(ref_ev[:, None] - ev[None, :]),
                                    axis=0)
                ref_ev = ref_ev[indices]
            elif len(ref_ev) < len(ev):
                raise RuntimeError(f"{ref_ev=} but {ev=}. Enlarged space?")
            residual = eigenvalueResidual(ev, ref_ev, [eMin, eMax])
            status["runTime"] = time.time() - status["startTime"]
            status["residual"] = residual
            printObj.writeFile("summary", ev, residual, status)
            if residual < eConv:
                status["isConverged"] = True
                break

        if N_SUBSPACE != len(Y):
            warnings.warn(
                f"Alert! Got {N_SUBSPACE - len(Y)} dependent vectors")
        N_SUBSPACE = len(Y)
        ref_ev = ev

    status["timers"] = timer.summary()
    printObj.writeFile("results", ev)
    printObj.fileFooter()
    printObj.close()

    return ev, Y, status
