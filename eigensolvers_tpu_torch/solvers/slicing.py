"""Spectrum slicing: every eigenpair in a (wide) interval, by load-balanced
FEAST windows sized from a stochastic spectral density estimate.

Port of the JAX package's ``solvers/slicing.py``:

1. **KPM spectral density** (:func:`chebyshev_moments`): a three-term
   Chebyshev recurrence over a batch of Rademacher probes gives stochastic
   moments mu_k ~ tr T_k(H) / n; every step is ONE lane-stack apply of the
   (nProbes, n) probe stack (one B3 launch on a block-sparse operator), and
   the moments come back to the host in one read.  Eigenvalue counts of
   any window (:func:`window_count_from_moments`), the cumulative spectral
   CDF and load-balanced window boundaries (:func:`partition_windows`) are
   then coefficient algebra on the host.  The count estimate also sizes
   each window's FEAST subspace.
2. **Windowed FEAST sweep** (:func:`spectrumSlicingDiagonalization`): each
   window runs FEAST (the fused loop, ``solvers/fast_feast.py``, when
   eligible); windows own half-open intervals [b_w, b_{w+1}) so merged
   eigenvalues are counted exactly once.  Boundary placement by CDF
   inversion lands the cuts in spectral gaps (flat CDF regions), where the
   rational filter's edges are numerically safest.  The merged pairs are
   polished by batched inverse iteration, and spurious and duplicate pairs
   are rejected.
"""

from __future__ import annotations

import math
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.linear_solvers import reduced
from ..ops.operators import (AbstractOperator, as_operator, default_device,
                             operator_device)
from ..utils.profiling import span, to_host
from .chebyshev import chebyshev_window_coefficients, estimate_spectral_bounds

__all__ = [
    "chebyshev_moments",
    "window_count_from_moments",
    "partition_windows",
    "estimate_spectral_density",
    "spectrumSlicingDiagonalization",
]


def chebyshev_moments(op, n: int, degree: int = 300, nProbes: int = 8,
                      bounds=None, seed: int = 0, dtype=np.float32,
                      reduce=None, rows=None):
    """Hutchinson-estimated Chebyshev moments of the Hermitian ``op``.

    Rademacher probes v with entries +-1 give E[v^T T_k(Hs) v] = tr T_k(Hs);
    the returned moments are normalized per state (divided by n), i.e.
    mu_k ~ tr T_k(Hs) / n, so window counts are ``n * sum_k c_k mu_k``.
    The probes are drawn on the host as the JAX package draws them and run
    on the operator's device.

    :param bounds: spectral interval (a, b); default: safe Lanczos bounds
        (:func:`chebyshev.estimate_spectral_bounds`)
    :param reduce, rows: for a row-sharded ``op``, the all-reduce over its
        ranks and this rank's rows of the probes; the ranks' partial
        moments are summed once, after the recurrence
    :returns: (mu (degree+1,) float64 host array, (a, b))
    """
    op = as_operator(op)
    if bounds is None:
        bounds = estimate_spectral_bounds(op, n, seed=seed, reduce=reduce,
                                          rows=rows)
    a, b = float(bounds[0]), float(bounds[1])
    c = (a + b) * 0.5
    h = (b - a) * 0.5

    rng = np.random.RandomState(seed)
    # +-1/sqrt(n) probes: unit norm, E[v v^T] = I/n -> per-state moments
    V = (rng.randint(0, 2, size=(nProbes, n)) * 2 - 1).astype(dtype)
    V /= math.sqrt(n)
    if rows is not None:
        V = V[:, rows]
    V = torch.as_tensor(V, device=operator_device(op))

    def scaled_apply(X):
        # cast back: an f64 operator must not promote an f32 probe carry
        return torch.sub(op.matvec_lanes(X).to(X.dtype), X, alpha=c).div_(h)

    mu = torch.empty(degree + 1, dtype=V.dtype, device=V.device)
    Tkm1, Tk = V, scaled_apply(V)
    mu[0] = (V * Tkm1).sum(dim=1).mean()
    mu[1] = (V * Tk).sum(dim=1).mean()
    for k in range(2, degree + 1):
        Tkp1 = scaled_apply(Tk).mul_(2.0).sub_(Tkm1)
        mu[k] = (V * Tkp1).sum(dim=1).mean()
        Tkm1, Tk = Tk, Tkp1
    return to_host(reduced(mu, reduce)).numpy().astype(np.float64), (a, b)


def window_count_from_moments(mu: np.ndarray, a: float, b: float,
                              lo: float, hi: float, n: int) -> float:
    """Estimated eigenvalue count in [lo, hi] from per-state moments ``mu``
    on the spectral interval [a, b] (Jackson-damped window expansion —
    same coefficients as the Chebyshev filter, evaluated as a dot)."""
    eps = 1e-9 * max(1.0, abs(b - a))
    lo = min(max(lo, a + eps), b - 2 * eps)
    hi = min(max(hi, lo + eps), b - eps)
    c = chebyshev_window_coefficients(len(mu) - 1, a, b, lo, hi,
                                      jackson=True)
    return float(n * np.dot(c, mu))


def estimate_spectral_density(mu: np.ndarray, a: float, b: float, n: int,
                              nGrid: int = 200):
    """Cumulative spectral distribution C(x) ~ #{ev <= x} on a uniform grid
    (KPM CDF).  :returns: (grid (nGrid,), counts (nGrid,))."""
    xs = np.linspace(a, b, nGrid + 2)[1:-1]
    counts = np.array([window_count_from_moments(mu, a, b, a, x, n)
                       for x in xs])
    return xs, np.maximum.accumulate(counts)


def partition_windows(mu: np.ndarray, a: float, b: float,
                      eMin: float, eMax: float, nWindows: int, n: int,
                      nGrid: int = 400) -> np.ndarray:
    """Load-balanced window boundaries: invert the KPM CDF so each of the
    ``nWindows`` slices of [eMin, eMax] holds ~the same eigenvalue count.
    CDF inversion places boundaries in spectral gaps (flat CDF), where the
    FEAST contour edge is numerically safest.

    :returns: boundaries, shape (nWindows + 1,), [eMin ... eMax]
    """
    xs = np.linspace(eMin, eMax, nGrid)
    cdf = np.array([window_count_from_moments(mu, a, b, eMin, x, n)
                    for x in xs])
    cdf = np.maximum.accumulate(cdf)
    total = cdf[-1]
    bounds = [eMin]
    for w in range(1, nWindows):
        target = total * w / nWindows
        i = int(np.searchsorted(cdf, target))
        i = min(max(i, 1), nGrid - 1)
        # linear interpolation inside the bracketing grid cell
        c0, c1 = cdf[i - 1], cdf[i]
        frac = 0.5 if c1 <= c0 else (target - c0) / (c1 - c0)
        bounds.append(float(xs[i - 1] + frac * (xs[i] - xs[i - 1])))
    bounds.append(eMax)
    return np.array(bounds)


def _polish_pairs(A, vecs, vals, rounds: int):
    """Batched inverse-iteration polish of Ritz pairs.

    FEAST's inexact contour solves leave each Ritz vector contaminated at
    the solver-residual level by spectrally DISTANT states, so vector
    residuals stall orders above the eigenvalue accuracy.  One shifted
    solve (sigma_i = Ritz value) damps a contaminant at distance d by
    ~|sigma - lambda|/d, then the Rayleigh quotient is recomputed.  All
    pairs polish as ONE batched solve (``TorchVector.solveBatch``: every
    MINRES pass one lane-stack apply).

    :returns: (vals, vecs, residuals) — residual = ||A v - lambda v||
    """
    typeClass = type(vecs[0])
    # the polish solves run far tighter than the window solves: the final
    # residual floor is set HERE (the shifted system at sigma ~ lambda is
    # near-singular; MINRES converges to the pseudo-inverse direction,
    # which is exactly inverse iteration)
    tight = dict(vecs[0].options)
    lsa = dict(tight.get("linearSystemArgs", {}))
    lsa["linear_tol"] = min(float(lsa.get("linear_tol", 1e-4)), 1e-8)
    lsa["linear_atol"] = min(float(lsa.get("linear_atol", 1e-4)), 1e-10)
    lsa["errorOnNonConvergence"] = False
    tight["linearSystemArgs"] = lsa
    vecs = [v.copy() for v in vecs]
    for v in vecs:
        v.options = tight
    for _ in range(max(0, rounds)):
        ws = typeClass.solveBatch(A, vecs, np.asarray(vals, float))
        vecs = [w.normalize() for w in ws]
        vals = [float(np.real(w.vdot(w.applyOp(A)))) for w in vecs]
    res = []
    for lam, w in zip(vals, vecs):
        r = typeClass.linearCombination([w.applyOp(A), w], [1.0, -lam])
        res.append(float(r.norm()))
    return vals, vecs, res


def spectrumSlicingDiagonalization(
        A, eMin: float, eMax: float, nWindows: Optional[int] = None,
        windows: Optional[Sequence[float]] = None,
        nc: int = 8, quad: str = "legendre", eConv: float = 1e-8,
        maxit: int = 10, contour_overlap: float = 0.0,
        polish_rounds: int = 2, residual_tol: Optional[float] = None,
        m0_margin: float = 0.5, m0_min: int = 4, m0_max: int = 64,
        degree: int = 300, nProbes: int = 8, bounds=None,
        options: Optional[dict] = None, seed: int = 0,
        vector_cls=None, device=None,
        writeOut: bool = False, status: Optional[dict] = None,
        **feast_kwargs):
    """Compute ALL eigenpairs of the Hermitian ``A`` in [eMin, eMax] by
    load-balanced windowed FEAST (see module docstring).

    :param A: Hermitian operator (dense matrix / AbstractOperator / SoP)
    :param nWindows: number of slices (default: sized so each window holds
        ~8 estimated eigenvalues)
    :param windows: explicit boundary array (overrides nWindows/balancing)
    :param contour_overlap: enlarge each window's FEAST contour by this
        fraction of the window width per side while OWNERSHIP stays the
        half-open [b_w, b_{w+1}).  Default 0; useful > 0 when a known
        cluster straddles a cut
    :param polish_rounds: batched inverse-iteration rounds on the merged
        eigenpairs (see :func:`_polish_pairs`); 0 disables the polish
        solves, but residuals are still computed and the spurious/duplicate
        rejection still runs (with a looser 1e-2-relative default cut)
    :param residual_tol: absolute cut on the POLISHED residual
        ||A v - lambda v|| above which a merged pair is dropped as spurious.
        Default None = relative cut 1e-4 * max(1, |lambda|) plus an
        interval-membership check; dropped count reported as
        status["dropped_spurious"]
    :param m0_margin: per-window subspace size = ceil(est_count * (1 +
        margin)) + 1, clipped to [m0_min, m0_max] — FEAST requires
        m0 > #ev inside the contour (est_count is measured on the ENLARGED
        contour window)
    :param degree, nProbes, bounds: KPM moment parameters
    :param options: vector options dict for the window guesses (solver
        settings; reference-style nested dict)
    :param vector_cls: guess-vector class, default ``TorchVector``
    :param device: where the guess vectors (and a host ``A``) are placed:
        default the operator's device if ``A`` is an operator, else the card
    :returns: (ev sorted ascending, vectors in the same order, status) —
        status carries per-window substatuses, count estimates, and the
        (a, b) spectral bounds used
    """
    import scipy.linalg as sla

    from ..vectors.dense import TorchVector
    from .feast import feastDiagonalization

    if vector_cls is None:
        vector_cls = TorchVector
    if device is None and isinstance(A, AbstractOperator):
        device = operator_device(A)
    device = default_device(device)
    A = as_operator(A, device=device)

    n = int(A.shape[0])
    # a row-sharded A (parallel.shard_operator) runs the moments on this
    # rank's rows of the probes; a whole A runs them whole on every rank
    mesh = getattr(A, "mesh", None)
    mu, (a, b) = chebyshev_moments(
        A, n, degree=degree, nProbes=nProbes, bounds=bounds, seed=seed,
        reduce=None if mesh is None else mesh.allreduce_x,
        rows=getattr(A, "rows", None))
    total_est = window_count_from_moments(mu, a, b, eMin, eMax, n)

    if windows is not None:
        bnds = np.asarray(windows, float)
        if bnds.ndim != 1 or len(bnds) < 2 or abs(bnds[0] - eMin) >= 1e-12 \
                or abs(bnds[-1] - eMax) >= 1e-12:
            raise ValueError(f"windows must run from eMin to eMax, got "
                             f"{bnds}")
    else:
        if nWindows is None:
            nWindows = max(1, int(math.ceil(total_est / 8.0)))
        bnds = partition_windows(mu, a, b, eMin, eMax, nWindows, n)

    rng = np.random.RandomState(seed + 1)
    opts = options or {"linearSystemArgs": {
        "linearSolver": "gcrotmk", "linearIter": 1000, "linear_tol": 1e-4,
        "errorOnNonConvergence": False}}

    all_ev: List[float] = []
    all_vecs: List = []
    win_stats = []
    # worklist of (lo, hi, owns_upper_edge, split_depth): a window whose
    # required subspace size exceeds m0_max is SPLIT in half rather than
    # silently clamped — FEAST needs m0 > #ev inside the contour, so a
    # clamped window would drop eigenpairs while still reporting
    # isConverged on its undersized subspace
    work = [(float(bnds[w]), float(bnds[w + 1]), w == len(bnds) - 2, 0)
            for w in range(len(bnds) - 1)]
    MAX_SPLIT_DEPTH = 6
    while work:
        lo, hi, last, depth = work.pop(0)
        guard = contour_overlap * (hi - lo)
        clo, chi = lo - guard, hi + guard
        est = window_count_from_moments(mu, a, b, clo, chi, n)
        m0_needed = math.ceil(est * (1.0 + m0_margin)) + 1
        if m0_needed > m0_max and depth < MAX_SPLIT_DEPTH:
            mid = 0.5 * (lo + hi)
            warnings.warn(
                f"spectrum slicing: window ({lo:.6g}, {hi:.6g}) needs "
                f"m0={m0_needed} > m0_max={m0_max}; splitting at {mid:.6g}")
            work.insert(0, (mid, hi, last, depth + 1))
            work.insert(0, (lo, mid, False, depth + 1))
            continue
        m0 = int(np.clip(m0_needed, m0_min, m0_max))
        clipped = m0 < m0_needed
        if clipped:
            warnings.warn(
                f"spectrum slicing: window ({lo:.6g}, {hi:.6g}) m0 clipped "
                f"to {m0} < required {m0_needed} at max split depth — "
                f"eigenpairs may be missed in this window")
        Y0 = sla.qr(rng.rand(n, m0), mode="economic")[0]
        Y = [vector_cls(Y0[:, i], opts, device=device) for i in range(m0)]
        with span("es.slicing.outer"):
            ev_w, uv_w, st_w = feastDiagonalization(
                A, Y, nc, quad, clo, chi, eConv, maxit,
                writeOut=writeOut, **feast_kwargs)
        # half-open ownership: [lo, hi) except the last window, [lo, hi]
        kept = [i for i, e in enumerate(np.asarray(ev_w))
                if lo <= e < hi or (last and abs(e - hi) < 1e-12 * max(
                    1.0, abs(hi)))]
        for i in kept:
            all_ev.append(float(ev_w[i]))
            all_vecs.append(uv_w[i])
        win_stats.append({
            "window": (lo, hi), "estimated": est, "m0": m0,
            "m0_clipped": clipped, "split_depth": depth,
            "found": len(kept),
            "isConverged": bool(st_w.get("isConverged")) and not clipped,
            "feast_status": st_w,
        })

    residuals = None
    dropped = 0
    if all_ev:
        # polish_rounds=0 still computes residuals (no solves) and runs the
        # same spurious/duplicate rejection: noise Ritz pairs from oversized
        # m0 landing inside a window's ownership interval must not be
        # returned as genuine eigenpairs.  The default residual cut is
        # looser without polishing.
        all_ev, all_vecs, residuals = _polish_pairs(A, all_vecs, all_ev,
                                                    polish_rounds)
        # spurious rejection: a noise-pair's Rayleigh quotient walks out of
        # the search interval and/or its residual stays O(1) under inverse
        # iteration (genuine pairs polish to near machine precision)
        margin = 1e-8 * max(1.0, abs(eMin), abs(eMax))
        default_cut = 1e-4 if polish_rounds > 0 else 1e-2

        def _genuine(lam, r):
            if not (eMin - margin <= lam <= eMax + margin):
                return False
            cut = (residual_tol if residual_tol is not None
                   else default_cut * max(1.0, abs(lam)))
            return r <= cut

        keep = [i for i, (lam, r) in enumerate(zip(all_ev, residuals))
                if _genuine(lam, r)]
        # duplicate collapse: inverse iteration converges a noise-pair onto
        # the genuine eigenvector nearest its (garbage) Ritz value, so two
        # polished pairs can be the SAME state.  Same value + overlapping
        # vectors = duplicate (orthogonal vectors at equal value = true
        # degeneracy, kept).  Best residual wins.
        by_quality = sorted(keep, key=lambda i: residuals[i])
        uniq = []
        for i in by_quality:
            dup = False
            for j in uniq:
                if (abs(all_ev[i] - all_ev[j])
                        < 1e-4 * max(1.0, abs(all_ev[j]))
                        and abs(all_vecs[i].vdot(all_vecs[j])) > 0.5):
                    dup = True
                    break
            if not dup:
                uniq.append(i)
        keep = sorted(uniq)
        dropped = len(all_ev) - len(keep)
        all_ev = [all_ev[i] for i in keep]
        all_vecs = [all_vecs[i] for i in keep]
        residuals = [residuals[i] for i in keep]

    order = np.argsort(all_ev)
    ev_sorted = np.array([all_ev[i] for i in order])
    vecs_sorted = [all_vecs[i] for i in order]

    # Convergence: every window's FEAST self-consistency metric, OR — when
    # polishing — a per-pair residual certificate (the ev-change metric can
    # stall just above eConv on a slow contour-edge spectator while every
    # OWNED pair is already polished; the certificate is the stronger
    # statement).
    windows_ok = all(s["isConverged"] for s in win_stats)
    certified = (residuals is not None and len(residuals) > 0 and
                 all(r <= eConv * max(1.0, abs(lam))
                     for r, lam in zip(residuals, all_ev)))
    out_status = dict(status or {})
    out_status.update({
        "isConverged": windows_ok or certified,
        "residual_certified": certified,
        "bounds": (a, b),
        "boundaries": bnds,
        "estimated_total": total_est,
        "found_total": len(ev_sorted),
        "dropped_spurious": dropped,
        "residuals": (None if residuals is None
                      else np.asarray(residuals)[order]),
        "windows": win_stats,
    })
    return ev_sorted, vecs_sorted, out_status
