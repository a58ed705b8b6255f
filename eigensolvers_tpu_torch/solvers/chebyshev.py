"""Chebyshev-filtered subspace iteration — the polynomial (solve-free)
window eigensolver.

Port of the JAX package's ``solvers/chebyshev.py``.  The rational contour
filter of FEAST is replaced by a damped Chebyshev polynomial approximation
of the window indicator function 1_{[eMin,eMax]}(H).  Each outer iteration
is a chain of operator applications with no inner linear solves: the
degree-d filter over the m0 subspace vectors is a three-term recurrence
whose every step is ONE lane-stack apply ``op.matvec_lanes`` of the (m0, n)
stack — one B3 launch (``bsr_spmm``) on a block-sparse operator, one GEMM
on a dense one.  The coefficients are host floats, so no step reads the
device.

Algorithm (Zhou, Saad, Tiago & Chelikowsky, J. Comput. Phys. 219, 172
(2006) for the filtered-subspace-iteration scheme; Jackson damping after
Weiße et al., Rev. Mod. Phys. 78, 275 (2006)):

  repeat:  W <- p_d(H) Y   (Chebyshev recurrence, Jackson-damped window
                            indicator on the spectral interval [a, b])
           Rayleigh-Ritz in span(W): Löwdin + projected eigh
           Y <- Ritz vectors; converge on the in-window eigenvalue
           residual exactly like FEAST

The convergence machinery (Löwdin orthogonalization with lindep-driven
subspace shrink, nearest-matching of reference eigenvalues, residual
restricted to the window, status dict, two-file reporting) mirrors
``feastDiagonalization``, so the two window solvers are drop-in
replacements for each other.

Mixed precision as in the JAX package, which always runs with x64 on: the
filter recurrence stays at the state dtype (the hot cost, ``degree``
applies), the Rayleigh-Ritz assembly is promoted to f64 (c128 for complex
states).  Every fp32 product runs with TF32 off (refused otherwise, see
:func:`~eigensolvers_tpu_torch.ops.operators.require_true_fp32`).

``writeOut=False`` runs the fused window loop (:func:`_fused_window`): the
JAX package's single ``lax.while_loop`` program becomes a loop on the
tensors' device whose only host read per outer iteration is the window
residual that decides whether to go on.
"""

from __future__ import annotations

import math
import time
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.linear_solvers import reduced
from ..ops.operators import operator_device
from ..utils.status import feast_status
from ..utils.subspace import (
    eigenvalueResidual,
    lowdinOrthoMatrix,
    diagonalizeHamiltonian,
)
from ..utils.reporting import FeastReporter
from ..utils.profiling import PhaseTimer, span, spans, to_host
from ..vectors.dense import _mm

__all__ = [
    "chebyshevFilteredDiagonalization",
    "chebyshev_window_coefficients",
    "estimate_spectral_bounds",
]


def chebyshev_window_coefficients(degree: int, a: float, b: float,
                                  eMin: float, eMax: float,
                                  jackson: bool = True) -> np.ndarray:
    """Chebyshev expansion coefficients of the window indicator.

    Expands 1_{[eMin,eMax]} on the spectral interval [a, b] (mapped to
    t in [-1, 1]) in Chebyshev polynomials T_k, k = 0..degree:

        c_0 = (theta_lo_hi span)/pi,   c_k = 2 (sin k*th_hi - sin k*th_lo)/(k pi)

    with th = acos(t) and optional Jackson damping factors g_k (kills the
    Gibbs oscillation of the truncated series; essential for a filter —
    undamped lobes outside the window re-amplify unwanted eigenvectors).
    """
    if not (a < eMin < eMax < b):
        raise ValueError(
            f"window [{eMin}, {eMax}] must lie strictly inside the "
            f"spectral interval [{a}, {b}]")
    c = (a + b) * 0.5
    h = (b - a) * 0.5
    t_lo = (eMin - c) / h
    t_hi = (eMax - c) / h
    th_hi = math.acos(t_lo)          # acos is decreasing: t_lo -> larger angle
    th_lo = math.acos(t_hi)
    k = np.arange(1, degree + 1, dtype=np.float64)
    coeffs = np.empty(degree + 1)
    coeffs[0] = (th_hi - th_lo) / math.pi
    coeffs[1:] = 2.0 * (np.sin(k * th_hi) - np.sin(k * th_lo)) / (k * math.pi)
    if jackson:
        d1 = degree + 1
        g = ((d1 - k + 1) * np.cos(math.pi * k / d1)
             + np.sin(math.pi * k / d1) / math.tan(math.pi / d1)) / d1
        coeffs[1:] *= g
    return coeffs


def _np_dtype(dtype) -> np.dtype:
    """A numpy dtype from a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def _vnorm(v, reduce):
    """||v|| over every rank's rows under ``reduce`` (see
    ``ops.linear_solvers``)."""
    nrm = torch.linalg.vector_norm(v)
    return nrm if reduce is None else reduce(nrm, "norm")


def _norm_rows(X, reduce):
    """||X_k|| of each row (kept as a column), over every rank's columns
    under ``reduce``."""
    nrm = torch.linalg.vector_norm(X, dim=1, keepdim=True)
    return nrm if reduce is None else reduce(nrm, "norm")


def estimate_spectral_bounds(op, n: int, iters: int = 30, seed: int = 0,
                             dtype=np.float64, reduce=None, rows=None):
    """Safe [a, b] enclosing the spectrum of the Hermitian ``op`` via a short
    Lanczos run (``iters`` single-vector applies, B1 on a block-sparse
    operator; one host read per step) with the standard residual-based
    safety margin b_est + ||r|| (Zhou & Li, upper-bound lemma).  ``dtype``
    (numpy or torch) is the start vector's, drawn as the JAX package draws
    it; the vector lives on the operator's device.  A row-sharded ``op``
    takes this rank's ``rows`` of the start vector and the reduction over
    the ranks (``reduce``)."""
    rng = np.random.RandomState(seed)
    v = torch.as_tensor(rng.rand(n).astype(_np_dtype(dtype)),
                        device=operator_device(op))
    if rows is not None:
        v = v[rows].contiguous()
    v = v / _vnorm(v, reduce)
    alphas, betas = [], []
    v_prev = torch.zeros_like(v)
    beta = 0.0
    for _ in range(iters):
        w = op.matvec(v)
        alpha = reduced(torch.vdot(v.to(w.dtype), w).real, reduce)
        w = w - alpha * v - beta * v_prev
        # alpha and ||w|| in one host read
        alpha_h, new_beta = to_host(torch.stack(
            [alpha, _vnorm(w, reduce)])).tolist()
        alphas.append(alpha_h)
        if new_beta < 1e-12:
            beta = 0.0
            break
        v_prev, v, beta = v, w / new_beta, new_beta
        betas.append(new_beta)
    T = np.diag(alphas)
    for i, b_ in enumerate(betas[:len(alphas) - 1]):
        T[i, i + 1] = T[i + 1, i] = b_
    ritz = np.linalg.eigvalsh(T)
    margin = betas[-1] if betas else 0.0
    return float(ritz[0] - margin), float(ritz[-1] + margin)


def _rr_dtype(W: torch.Tensor) -> torch.dtype:
    """The Rayleigh-Ritz (and polish) dtype: f64, or c128 for complex W."""
    return torch.complex128 if W.is_complex() else torch.float64


def _filter_stack(op, W, coeffs, a, b, reduce=None):
    """Normalized p_d(op) @ W = sum_k c_k T_k((op - c)/h) W for the stacked
    subspace W (m0, n), [a, b] = c -+ h: the three-term Chebyshev
    recurrence, T_1 and every later step one ``op.matvec_lanes`` of the
    whole stack (``degree`` applies), then a handful of elementwise
    updates.  The coefficients are host floats: no step reads the
    device."""
    cf = [float(x) for x in coeffs]
    c, h = (a + b) * 0.5, (b - a) * 0.5
    T0 = W
    T1 = torch.sub(op.matvec_lanes(W), W, alpha=c).div_(h)
    acc = cf[0] * T0 + cf[1] * T1
    Tkm1, Tk = T0, T1
    for ck in cf[2:]:
        # T_{k+1} = 2 (op - c)/h T_k - T_{k-1}
        Tkp1 = torch.sub(op.matvec_lanes(Tk), Tk, alpha=c).mul_(2.0 / h)
        Tkp1.sub_(Tkm1)
        acc.add_(Tkp1, alpha=ck)
        Tkm1, Tk = Tk, Tkp1
    nrm = _norm_rows(acc, reduce)
    return acc / torch.where(nrm > 0, nrm, 1.0)


def _gram_pair(Wrr, AW, reduce):
    """S = W W^H and the symmetrized Hm = W (A W)^H of a stack, both
    summed over the ranks in one reduction."""
    S = Wrr.conj() @ Wrr.T
    Hm = Wrr.conj() @ AW.T
    SH = reduced(torch.stack([S, Hm]), reduce)
    return SH[0], 0.5 * (SH[1] + SH[1].conj().T)


def _filter_rr(op, W, coeffs, a, b, reduce=None):
    """Filter + subspace assembly: returns (W_filtered on the device, S and
    Hm as host arrays from ONE read).  The assembly is promoted to f64
    (f32 products are exact in f64; only the reduction rounds)."""
    Wf = _filter_stack(op, W, coeffs, a, b, reduce)
    Wrr = Wf.to(_rr_dtype(Wf))
    S, Hm = _gram_pair(Wrr, op.matvec_lanes(Wrr), reduce)
    SH = to_host(torch.stack([S, Hm])).numpy()        # single host read
    return Wf, SH[0], SH[1]


def _replenishment_pool(shape, dtype, device) -> torch.Tensor:
    """Unit rows that replace dead subspace rows in the fused loop: normal
    draws of a ``torch.Generator`` seeded 1234 (the JAX package draws
    them from ``jax.random.key(1234)``, so the numbers differ)."""
    gen = torch.Generator(device=device).manual_seed(1234)
    R0 = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return R0 / torch.linalg.vector_norm(R0, dim=1, keepdim=True)


def _rr_round(op, Wc, coeffs, a, b, R0, reduce=None):
    """One fused outer iteration: filter -> f64 Rayleigh-Ritz (m0 x m0
    eigh on the device, regularized Löwdin) -> basis rotation.  Returns
    (W at Wc's dtype, ev).

    Repeated f32 filtering kills subspace directions whose filter gain
    ratio decays below the f32 floor (at unlucky degrees S loses rank by
    iteration 3-4, and a CLAMPED Löwdin would amplify the dead directions
    into junk Ritz vectors that displace real states).  Dead directions
    are hard-DROPPED (zeroed) and their rows replaced with the unit rows of
    ``R0``, so the subspace keeps m0 useful dimensions."""
    f64 = _rr_dtype(Wc)
    Wrr = _filter_stack(op, Wc, coeffs, a, b, reduce).to(f64)
    S, Hm = _gram_pair(Wrr, op.matvec_lanes(Wrr), reduce)
    s, U = torch.linalg.eigh(S)
    X = U / torch.sqrt(torch.clamp(s, min=1e-12)) * (s > 1e-8)
    Ht = X.conj().T @ Hm @ X
    ev, V = torch.linalg.eigh(0.5 * (Ht + Ht.conj().T))
    Wn = (X @ V).T @ Wrr
    nrm = _norm_rows(Wn, reduce)
    dead = nrm < 0.5          # unit rows expected; dropped dims ~ 0
    Wn = torch.where(dead, R0.to(f64), Wn / torch.where(nrm > 0, nrm, 1.0))
    # dead rows carry ev=0 from the zeroed Löwdin columns; move them to a
    # finite out-of-window sentinel so the residual mask never counts them
    # (inf would make |ev - ref| nan when both are dead)
    sentinel = abs(a + b) * 0.5 + 1e3 * abs(b - a) * 0.5 + 1e6
    ev = torch.where(dead[:, 0], torch.full_like(ev, sentinel), ev)
    return Wn.to(Wc.dtype), ev


def _window_residual(ev, ref, eMin, eMax):
    """eigenvalueResidual restricted to [eMin, eMax] (fixed-size masked
    form; ev and ref are same-length sorted eigh outputs), on the device."""
    m = (ev >= eMin) & (ev <= eMax)
    d = torch.abs(ev - ref)
    num = torch.where(m, d, 0.0).sum()
    den = torch.where(m, torch.abs(ev), 0.0).sum()
    if_none = d.sum() / torch.clamp(torch.abs(ev).sum(), min=1e-300)
    return torch.where(m.any(), num / torch.clamp(den, min=1e-300), if_none)


def _enrich(op, Wcur, reduce=None):
    """Terminal polish: one residual-enriched f64 Rayleigh-Ritz round.

    The converged f32 filter subspace carries a systematic ~1e-2-angle
    error (a deterministic f32 fixed point) that floors the Ritz values at
    ~2-4e-4; the residual vectors R = A W - lambda W are orthogonal to the
    Ritz subspace and span its first-order error, so an f64 RR over
    [W; R] removes the floor at the cost of 2 m0 f64 applies (two lane
    stacks).  Two safety rules keep the round junk-free:

    * a residual row whose norm is below 1e-8 * max(1, |lam|) is ZEROED,
      not normalized (normalizing a machine-precision residual amplifies
      rounding noise into a vector whose Rayleigh quotient clusters at the
      spectral centroid and displaces real states);
    * zero rows make S2 eigenvalues exactly 0, so Löwdin columns below 1e-8
      are dropped outright, never amplified by the clamp.

    Selection back to m0 states: the enriched Ritz vectors with the largest
    old-subspace content (the m0 perturbative continuations carry weight
    ~1, junk ~0).  ONE round only: a second computes residuals of
    near-converged states, whose normalized directions are noise and MIX
    error back in."""
    m0 = Wcur.shape[0]
    Wrr = Wcur.to(_rr_dtype(Wcur))
    AW = op.matvec_lanes(Wrr)
    quot = reduced(torch.stack([(Wrr.conj() * AW).sum(dim=1).real,
                                (Wrr.conj() * Wrr).sum(dim=1).real]), reduce)
    lam = quot[0] / torch.clamp(quot[1], min=1e-300)
    R = AW - lam[:, None] * Wrr
    Rn = _norm_rows(R, reduce)
    healthy = Rn > 1e-8 * torch.clamp(torch.abs(lam), min=1.0)[:, None]
    R = R / torch.where(Rn > 0, Rn, 1.0) * healthy
    B = torch.cat([Wrr, R])                              # (2 m0, n)
    AB = torch.cat([AW, op.matvec_lanes(R)])
    S2, H2 = _gram_pair(B, AB, reduce)
    s2, U2 = torch.linalg.eigh(S2)
    X2 = U2 / torch.sqrt(torch.clamp(s2, min=1e-12)) * (s2 > 1e-8)
    Ht2 = X2.conj().T @ H2 @ X2
    ev2, V2 = torch.linalg.eigh(0.5 * (Ht2 + Ht2.conj().T))
    uSH2 = X2 @ V2                                       # (2 m0, 2 m0)
    weight = (torch.abs(uSH2[:m0, :]) ** 2).sum(dim=0)
    keep = torch.sort(torch.topk(weight, m0).indices).values
    ev_out = ev2[keep]
    order = torch.argsort(ev_out)
    ev_out = ev_out[order]
    Wsel = uSH2[:, keep[order]].T @ B
    nrm = _norm_rows(Wsel, reduce)
    return Wsel / torch.where(nrm > 0, nrm, 1.0), ev_out


def _fused_window(op, W, coeffs, a, b, eMin, eMax, eConv, maxit,
                  reduce=None, rows=None, n=None):
    """The WHOLE filtered-subspace iteration on the tensors' device: rounds
    of :func:`_rr_round` while the windowed eigenvalue-change residual is
    at least ``eConv`` and fewer than ``maxit`` rounds ran (the JAX
    package's ``lax.while_loop``; here one host read of the residual per
    round decides), then one :func:`_enrich` round and the per-state
    certificate ||A w - lambda w||: a stable-but-WRONG filter fixed point
    converges the eigenvalue change while the vector residuals stay O(1),
    and the certificate makes that visible to the caller.

    Returns (W (m0, n) f64, ev, residual, rounds, vector residuals), all
    but ``residual`` and ``rounds`` on the device.  A row-sharded W (this
    rank's ``rows`` of states of length ``n``) reduces every state
    contraction over the ranks (``reduce``)."""
    R0 = _replenishment_pool((W.shape[0], n or W.shape[1]), W.dtype,
                             W.device)
    if rows is not None:          # every rank draws the whole pool
        R0 = R0[:, rows].contiguous()
    with span("es.chebyshev.outer"):
        Wc, ev_ref = _rr_round(op, W, coeffs, a, b, R0, reduce)
    res, rounds = math.inf, 1
    while res >= eConv and rounds < maxit:
        with span("es.chebyshev.outer"):
            Wc, ev = _rr_round(op, Wc, coeffs, a, b, R0, reduce)
            res = float(to_host(_window_residual(ev, ev_ref, eMin, eMax)))
        ev_ref, rounds = ev, rounds + 1
    Wsel, ev_out = _enrich(op, Wc, reduce)
    vec_res = _norm_rows(op.matvec_lanes(Wsel) - ev_out[:, None] * Wsel,
                         reduce)[:, 0]
    return Wsel, ev_out, res, rounds, vec_res


def adaptive_degree(a: float, b: float, eMin: float, eMax: float,
                    dmin: int = 200, dmax: int = 8000) -> int:
    """Filter degree from the spectral span / window width ratio.

    The Jackson-damped indicator's transition width is ~pi*(b-a)/d, so the
    minimum discriminating degree is ~pi*(b-a)/width; 3.5*(span/width)
    (~1.1x the pi threshold) buys margin at linear-in-d cost (the JAX
    package's choice, measured there on its 2048-dense bench window:
    degrees right at the threshold are fragile).  Occasional
    degree-specific collapses are caught by the vector-residual certificate
    and retried at an escalated degree by the fused driver."""
    width = max(float(eMax) - float(eMin), 1e-300)
    d = int(round(3.5 * (float(b) - float(a)) / width))
    return int(np.clip(d, dmin, dmax))


def chebyshevFilteredDiagonalization(
        A, Y: List, degree: Optional[int], eMin: float, eMax: float,
        eConv: float, maxit: int,
        specBounds: Optional[Sequence[float]] = None,
        jackson: bool = True,
        writeOut: bool = True, eShift: float = 0.0, convertUnit: str = "au",
        outFileName: Optional[str] = None, summaryFileName: Optional[str] = None,
        status: Optional[dict] = None):
    """All eigenpairs of the Hermitian ``A`` inside [eMin, eMax] by
    Chebyshev-filtered subspace iteration (see module docstring).

    Same call/return shape as :func:`feastDiagonalization`: ``(ev, Y,
    status)`` with the FEAST status keys; ``degree`` replaces FEAST's
    ``nc``/``quad`` (pass ``None`` for the adaptive degree,
    :func:`adaptive_degree`).  ``Y`` must be an array-backed backend
    (``TorchVector``, or ``ShardedVector``: each rank filters its rows,
    every state contraction reduces over the mesh, and the results are
    ``ShardedVector`` s on the same mesh): the polynomial filter is a
    dense-subspace method.  The work runs on the vectors' device.

    :param specBounds: (a, b) enclosing the FULL spectrum; estimated with a
        short Lanczos run when None.
    """
    vec_cls = type(Y[0])
    if not hasattr(Y[0], "array"):
        raise TypeError(
            "chebyshevFilteredDiagonalization needs an array-backed "
            f"backend, got {vec_cls.__name__}; use feastDiagonalization "
            "for compressed backends")
    options = Y[0].options
    m0 = len(Y)
    n = Y[0].size                 # the whole state's, padding included
    # sharded states: this rank's rows, and the reduction over the ranks
    red = vec_cls._reducer(Y[0]) if hasattr(vec_cls, "_reducer") else None
    rows = getattr(Y[0], "rows", None)

    op = vec_cls._as_operator(A, Y[0]) if hasattr(vec_cls, "_as_operator") \
        else A

    if specBounds is None:
        specBounds = estimate_spectral_bounds(
            op, n, dtype=torch.promote_types(Y[0].dtype, torch.float32),
            reduce=red, rows=rows)
    a, b = float(specBounds[0]), float(specBounds[1])
    # keep the window strictly inside the interval even for user bounds
    pad = 1e-3 * (b - a)
    a = min(a, eMin - pad)
    b = max(b, eMax + pad)
    adaptive = degree is None
    if adaptive:
        degree = adaptive_degree(a, b, eMin, eMax)
    coeffs = chebyshev_window_coefficients(degree, a, b, eMin, eMax, jackson)

    status = feast_status(status, Y)
    status["degree"] = degree
    status["specBounds"] = (a, b)
    printObj = FeastReporter(Y, degree, "chebyshev", eMin, eMax, eConv,
                             maxit, status.get("writeOut", writeOut), eShift,
                             convertUnit, status, outFileName,
                             summaryFileName)
    printObj.fileHeader()

    W = torch.stack([y.array.reshape(-1) for y in Y])
    N_SUBSPACE = m0
    ev = np.full(m0, np.nan)
    ref_ev = None
    timer = PhaseTimer("es.chebyshev", W.device)
    # the polish dtype of the terminal upcast iteration below
    ptype = _rr_dtype(W)

    if not printObj.writeOut:
        # fused path (see _fused_window): the per-iteration reporting hooks
        # are the only reason to run the host loop below.  Certificate-gated
        # degree escalation: at occasional degrees the sharp filter makes
        # the first iterations' overlap too ill-conditioned for the
        # regularized Löwdin and the loop settles on a wrong stable fixed
        # point; the vector-residual certificate detects it (in-window
        # state at O(operator-scale) residual) and the run retries at 1.4x
        # the degree
        degree_try = degree
        for attempt in range(3):
            coeffs_try = (coeffs if degree_try == degree else
                          chebyshev_window_coefficients(
                              degree_try, a, b, eMin, eMax, jackson))
            with timer.phase("fused_window"):
                Wd, ev_d, residual, iters, vres_d = _fused_window(
                    op, W, coeffs_try, a, b, eMin, eMax, eConv, maxit,
                    red, rows, n)
                packed = to_host(torch.cat([ev_d, vres_d])).numpy()  # ONE
            ev = packed[:m0]
            vec_res = packed[m0:]
            scale = max(abs(a), abs(b))
            bad = (ev >= eMin) & (ev <= eMax) & (vec_res > 0.05 * scale)
            if not bad.any():
                break
            if not adaptive or attempt == 2:
                warnings.warn(
                    f"chebyshev window: {int(bad.sum())} in-window "
                    f"state(s) carry O(1) vector residuals "
                    f"(max {float(vec_res[bad].max()):.2e}) — wrong "
                    f"filter fixed point; increase degree")
                break
            degree_try = int(round(degree_try * 1.4))
            warnings.warn(
                f"chebyshev window: certificate failed at degree "
                f"{int(degree_try / 1.4)}; retrying at {degree_try}")
        status["outerIter"] = iters - 1
        status["quadrature"] = degree_try
        status["degree"] = degree_try
        status["residual"] = residual
        status["vecResiduals"] = vec_res
        status["isConverged"] = bool(residual < eConv) and not bad.any()
        status["runTime"] = time.time() - status["startTime"]
        if not status["isConverged"]:
            warnings.warn(
                f"chebyshev window not converged in {iters} iterations "
                f"(residual {residual:.2e})")
        status["timers"] = timer.summary()
        printObj.close()
        return ev, [Y[0]._like(w, options) for w in Wd], status

    for it in spans("es.chebyshev.outer", range(maxit)):
        status["outerIter"] = it
        status["quadrature"] = degree      # reporter's per-iteration counter

        with timer.phase("filter_rr"):
            W, Smat, Hmat = _filter_rr(op, W, coeffs, a, b, red)

        printObj.writeFile("iteration", status)
        printObj.writeFile("overlap", Smat)

        status, uS = lowdinOrthoMatrix(Smat, status)
        ev, uv = diagonalizeHamiltonian(uS, Hmat, printObj)
        uSH = uS @ uv
        # stacked basis transformation: Y_j = sum_i uSH[i, j] W_i
        W = _mm(torch.as_tensor(uSH.T, dtype=W.dtype, device=W.device), W)

        if it != 0:
            if len(ref_ev) > len(ev):
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
                if W.dtype != ptype:
                    # mixed-precision polish: the f32 filter is
                    # deterministic, so its fixed point carries a systematic
                    # span error that more f32 iterations cannot reduce.
                    # Upcast the carry and run ONE f64 filter+RR iteration
                    # (`degree` promoted applies, paid once at convergence).
                    W = W.to(ptype)
                    ref_ev = ev
                    N_SUBSPACE = W.shape[0]
                    continue
                status["isConverged"] = True
                break

        if N_SUBSPACE != W.shape[0]:
            warnings.warn(
                f"Alert! Got {N_SUBSPACE - W.shape[0]} dependent vectors")
        N_SUBSPACE = W.shape[0]
        ref_ev = ev

    status["timers"] = timer.summary()
    printObj.writeFile("results", ev)
    printObj.fileFooter()
    printObj.close()
    return ev, [Y[0]._like(w, options) for w in W], status
