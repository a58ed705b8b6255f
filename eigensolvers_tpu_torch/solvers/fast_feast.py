"""Fused FEAST outer iteration: the whole rational-filter application as one
function on device tensors, with one host read of the subspace matrices.

Per outer iteration :func:`feast_filter_program` runs, on the card:

  1. the previous iteration's Rayleigh-Ritz basis rotation
     Y = C @ Ybase   (C = (uS uv)^T from the host eigh, so
     ``basisTransformation`` costs no vector objects);
  2. lane tiling B[(k,i)] = Y[i] and the Ritz warm-start seeds
     x0[(k,i)] = Y[i] / (z_k - ev_i)  (solvers/feast.py::_ritz_warm_starts);
  3. the batched split-complex J-MINRES contour solves
     (ops/linear_solvers.py::_splitc_batch), every pass one apply of H to
     the whole (2 nk m0, n) lane stack;
  4. the quadrature accumulation  Q_i = sum_k Re[mult_k x_{k,i}];
  5. subspace assembly  S = Q Q^T,  Hm = Q (A Q)^T.

The host then does what the generic loop does with (S, Hm): Löwdin,
projected eigh, convergence and shrink logic (m0 x m0, LAPACK).  Beside the
lane MINRES's own per-pass reads, an outer iteration reads (S, Hm) back
once; the per-lane results are host arrays already.

In the JAX package this was one jitted XLA program per iteration, a TPU
dispatch concern; here the same steps run eagerly on the tensors' device.
Semantics are identical to the generic path; ``solvers/feast.py`` routes
here when eligible (a ``TorchVector`` subspace, real symmetric operator,
split-complex solves, no lane chunking, no exact solves).
"""

from __future__ import annotations

import torch

from ..ops.linear_solvers import _splitc_batch
from ..utils.profiling import span
from ..vectors.dense import TorchVector, _mm

__all__ = ["feast_filter_program", "fused_eligible"]


def feast_filter_program(op, Ybase, C, sig_re, sig_im, mult_re, mult_im,
                         ritz_ev, rtol, atol, maxiter, precond=None,
                         warm=False, escalate=3):
    """One fused FEAST iteration: basis rotation, contour solves,
    quadrature accumulation and subspace assembly.

    Parameters
    ----------
    op : AbstractOperator (real symmetric)
    Ybase : (mb, n) real tensor at the carry dtype — the previous filtered
        subspace (or the initial guesses on the first iteration)
    C : (m0, mb) tensor at the carry dtype — the Rayleigh-Ritz rotation;
        identity on the first iteration.  Y = C @ Ybase is the subspace.
    sig_re, sig_im : (nk,) contour node components at the SOLVE dtype
        (z_k = sig_re + i sig_im)
    mult_re, mult_im : (nk,) quadrature multipliers
        -0.5 w_k r (e cos(theta_k) + i sin(theta_k)) at the carry dtype
    ritz_ev : (m0,) previous Ritz values at the solve dtype (used only when
        ``warm``)
    rtol, atol : solve tolerances
    maxiter, precond, escalate : solver controls
    warm : seed the solves with x0_{k,i} = Y_i / (z_k - ev_i)

    Returns (Q, S, Hm, res): Q (m0, n) stays on the device as the next
    iteration's Ybase; ``res`` is the split solve's SolveResult without its
    x (per-lane resnorm, iterations, converged as numpy arrays; matvecs the
    stack applies).

    Mixed precision BY DESIGN: the contour solves (the hot cost) run at the
    solve dtype (f32 for f32 states), the basis rotation, quadrature
    accumulation and S/Hm assembly at the carry dtype (f64).  An all-f32
    outer iteration stalls at ~1e-3 eigenvalue error; carrying the
    filtered subspace in f64 lets Rayleigh-Ritz average the independent
    f32 solve errors down.  Every product runs at true fp32 or f64: TF32 is
    refused (:func:`~eigensolvers_tpu_torch.ops.operators.require_true_fp32`).
    """
    sdtype = sig_re.dtype
    Y = _mm(C, Ybase)                                    # (m0, n) carry
    m0, n = Y.shape
    nk = sig_re.shape[0]
    B = Y.to(sdtype).repeat(nk, 1)                       # lane (k, i), k major
    sre = sig_re.repeat_interleave(m0)
    sim = sig_im.repeat_interleave(m0)
    X0 = None
    if warm:
        # Ritz warm starts (split re/im): 1/(z_k - ev_i), guarded when a
        # real contour node sits on a Ritz value
        dre = sig_re[:, None] - ritz_ev[None, :]         # (nk, m0)
        dim = sig_im[:, None].expand_as(dre)
        den = dre * dre + dim * dim
        ok = den > 1e-24
        den = torch.where(ok, den, torch.ones_like(den))
        zero = torch.zeros_like(den)
        cre = torch.where(ok, dre / den, zero).reshape(-1)     # Re 1/d
        cim = torch.where(ok, -dim / den, zero).reshape(-1)    # Im 1/d
        X0 = torch.cat([B * cre[:, None], B * cim[:, None]], dim=1)
    with span("es.linear.solve"):
        res = _splitc_batch(op, B, sre, sim, X0, rtol, atol, 1.0, maxiter,
                            precond=precond, escalate=escalate)
    X = res.x.to(Y.dtype)                                # (nk*m0, 2, n)
    Xr = X[:, 0, :].reshape(nk, m0, n)
    Xi = X[:, 1, :].reshape(nk, m0, n)
    # Q_i = sum_k Re[mult_k (Xr + i Xi)] in real arithmetic at the carry dtype
    Q = (torch.tensordot(mult_re, Xr, dims=([0], [0]))
         - torch.tensordot(mult_im, Xi, dims=([0], [0])))
    S = _mm(Q, Q.T)
    Hm = _mm(Q, op.matvec_lanes(Q).T)
    return Q, S, Hm, res._replace(x=None)


def fused_eligible(typeClass, A, Y, use_split):
    """Fused-loop eligibility (see the module docstring for the
    exclusions)."""
    if typeClass is not TorchVector or not use_split:
        return False
    opts = Y[0].options.get("linearSystemArgs", {})
    if opts.get("batchChunk"):
        return False                # memory-bounded lane chunking requested
    if opts.get("linearSolver") in ("exact", "pardiso"):
        return False
    return True
