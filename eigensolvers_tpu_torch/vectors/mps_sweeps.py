"""Two-site DMRG / ALS sweep engines for MPS chains (the JAX package's
``vectors/mps_sweeps.py``): ``dmrg_eigensolve`` for the lowest eigenpairs of
an MPO, ``als_solve`` for shifted linear systems
``(sign) * (sigma*I - H) x = b``.

This is the algorithmic counterpart of the reference's external sweep engine
(reference: ttnsVector.py:169-196 runs a ``ttns2.sweepAlgorithms.
LinearSystem`` sweep): the state is optimized two sites at a time against
exact left/right environments of the MPO and the RHS, each local problem
solved iteratively, and the two-site tensor split by SVD with
``maxD``/``eps`` truncation (bond adaptation).

Placement: the environments, the local operator (``_local_matvec``) and the
splits (``_split_two_site``) are torch work on the state's device.  The
local iterative solvers compute what the JAX package's scipy ones do
(ARPACK ``eigsh``, which its LOBPCG call resolves to, see
:func:`local_lowest`; ``gcrotmk``): they run on the host over a ``scipy.sparse.linalg.LinearOperator`` whose matvec copies
the local vector to the device, applies the torch contraction there and
copies the result back — one local vector each way per matvec, nothing
else.  The iterates are then those of the JAX package, up to roundoff.
Moving the local solvers onto the device is separate work (ROADMAP A.10).

Conventions: MPS site tensors (Dl, n, Dr); MPO site tensors
(Wl, n_out, n_in, Wr) as built by
:class:`~eigensolvers_tpu_torch.vectors.mps.MPO`.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import scipy.sparse.linalg as spla
import torch

from .mps import (host_reads, keep_count, mps_random, mps_vdot,
                  numpy_dtype, result_type, svd, to_tensors, torch_dtype)


# ----------------------------------------------------------------------------
# host <-> device bridge of the local solvers
# ----------------------------------------------------------------------------
def to_host(t: torch.Tensor) -> np.ndarray:
    """One local tensor to the host (flattened numpy)."""
    host_reads["local"] += 1
    return t.detach().resolve_conj().reshape(-1).cpu().numpy()


def host_matvec(apply, shape, dtype, device):
    """A matvec over host vectors for scipy: each call copies its vector to
    ``device`` (reshaped to ``shape``), runs ``apply`` there and copies the
    result back, flattened."""
    tdtype = torch_dtype(dtype)

    def mv(v):
        return to_host(apply(torch.as_tensor(
            np.asarray(v).reshape(shape), dtype=tdtype, device=device)))

    return mv


def local_lowest(mv, theta0: np.ndarray, tol: float, size: int, dtype,
                 on_fail, keep_converged: bool = True):
    """Lowest eigenpair of the local operator ``mv`` (host vectors) from
    ``theta0``: the start itself, normalized, with its Rayleigh quotient
    when its residual ``||A x - rho x||`` is within ``tol`` (and
    ``keep_converged``); else ARPACK ``eigsh`` (tol ``max(tol, 1e-8)``), a
    partial ARPACK result or ``on_fail()`` after that.

    This is what the JAX package's local eigensolver computes.  It calls
    LOBPCG with a Jacobi preconditioner built as a ``LinearOperator``
    whose matvec divides by the shift vector; scipy's LOBPCG (1.17)
    applies it to an (n, 1) block, the division broadcasts to (n, n), and
    the call raises unless the start has already converged (LOBPCG checks
    before it preconditions) — so ARPACK does the work.  Its deflated
    operator fails on the (n, 1) block too, so a deflated problem goes to
    ARPACK at once (``keep_converged=False``).  Scipy versions that apply
    the preconditioner as a matmat instead run LOBPCG with that shift,
    which is indefinite, and miss the lowest state: a tree DMRG of the
    CH3CN N = 8 rung ended at 44,370 cm-1 instead of 9,837.5 with scipy
    1.18.1.  Spelling the computation out keeps it one algorithm on every
    scipy."""
    if keep_converged:
        x = theta0 / np.linalg.norm(theta0)
        ax = mv(x)
        rho = np.real(np.vdot(x, ax))
        if np.linalg.norm(ax - rho * x) <= tol:
            return float(rho), x
    A = spla.LinearOperator((size, size), matvec=mv, dtype=dtype)
    try:
        ev, uv = spla.eigsh(A, k=1, which="SA", v0=theta0.ravel(),
                            maxiter=400, tol=max(tol, 1e-8))
        return float(ev[0]), uv[:, 0]
    except spla.ArpackNoConvergence as e:
        if len(e.eigenvalues):
            return float(e.eigenvalues[0]), e.eigenvectors[:, 0]
        return on_fail()


class Deflation:
    """Hard projection of a local problem out of the span of the lower
    states' local vectors (orthonormal basis ``D`` on the device):
    ``P = I - D D^H``; the deflated operator is ``P H P + penalty (I - P)``,
    whose deflated directions are exact eigendirections at ``penalty``."""

    def __init__(self, vecs, penalty):
        self.D = None
        self.penalty = penalty
        dvs = []
        for v in vecs:
            v = v.reshape(-1)
            nv = float(torch.linalg.vector_norm(v))
            if nv > 1e-14:
                dvs.append(v / nv)
        if dvs:
            Q, R = torch.linalg.qr(torch.stack(dvs, dim=1))
            keep = (torch.abs(torch.diagonal(R)) > 1e-12).cpu().numpy()
            if keep.any():
                self.D = Q[:, torch.as_tensor(np.flatnonzero(keep),
                                              device=Q.device)]

    def project(self, v):
        D = self.D
        return v - D @ (D.conj().T @ v)

    def start(self, theta0: torch.Tensor, seed: int) -> torch.Tensor:
        """theta0 projected (a numpy ``RandomState(seed)`` draw projected
        instead if theta0 lies inside the deflated space), at theta0's
        norm."""
        if self.D is None:
            return theta0
        t0 = self.project(theta0.reshape(-1))
        nt = float(torch.linalg.vector_norm(t0))
        if nt < 1e-12:
            r = np.random.RandomState(seed).standard_normal(theta0.numel())
            t0 = self.project(torch.as_tensor(r, dtype=theta0.dtype,
                                              device=theta0.device))
            nt = float(torch.linalg.vector_norm(t0))
        return (t0 / nt).reshape(theta0.shape) * \
            torch.linalg.vector_norm(theta0)

    def wrap(self, apply):
        """The deflated local operator around ``apply`` (flat tensors)."""
        if self.D is None:
            return apply
        return lambda v: (self.project(apply(self.project(v)))
                          + self.penalty * (v - self.project(v)))


def local_eigen(apply, theta0: torch.Tensor, tol: float, dtype,
                energy_fallback=None, deflated=False):
    """Lowest eigenpair of the local operator ``apply`` (flat device tensor
    -> flat device tensor) from ``theta0``: dense ``eigh`` for size <= 4,
    else :func:`local_lowest` on the host, whose every matvec copies the
    local vector to the device and back.  Returns (energy or
    ``energy_fallback``, theta on the device)."""
    shape = tuple(theta0.shape)
    size = theta0.numel()
    dev = theta0.device
    tdtype = torch_dtype(dtype)
    if size <= 4:
        eye = torch.eye(size, dtype=tdtype, device=dev)
        dense = torch.stack([apply(e) for e in eye], dim=1)
        evs, uvs = torch.linalg.eigh((dense + dense.conj().T) / 2)
        return float(evs[0]), uvs[:, 0].reshape(shape)

    mv = host_matvec(apply, (size,), tdtype, dev)

    def on_fail():
        return energy_fallback, to_host(theta0)

    e, vec = local_lowest(mv, to_host(theta0), tol, size,
                          numpy_dtype(tdtype), on_fail,
                          keep_converged=not deflated)
    return e, torch.as_tensor(np.asarray(vec), dtype=tdtype,
                              device=dev).reshape(shape)


def local_solve(apply, rhs: torch.Tensor, theta0: torch.Tensor, tol: float,
                maxiter: int, dtype):
    """``gcrotmk`` on the host for the local system ``apply(x) = rhs`` from
    ``theta0`` (the JAX package's local linear solver)."""
    shape = tuple(theta0.shape)
    size = math.prod(shape)
    A = spla.LinearOperator(
        (size, size), matvec=host_matvec(apply, shape, dtype, theta0.device),
        dtype=numpy_dtype(torch_dtype(dtype)))
    sol, _ = spla.gcrotmk(A, to_host(rhs), x0=to_host(theta0), rtol=tol,
                          atol=0.0, maxiter=maxiter)
    return torch.as_tensor(sol, dtype=torch_dtype(dtype),
                           device=theta0.device).reshape(shape)


# ----------------------------------------------------------------------------
# chain environments and local algebra
# ----------------------------------------------------------------------------
def _env_left_op(L, xk_bra, Wk, xk_ket):
    """L (a_bra, w, a_ket) extended by one site of <x|W|x>."""
    t1 = torch.tensordot(L, xk_bra.conj(), dims=([0], [0]))  # (w, a_ket, n, A)
    t2 = torch.tensordot(t1, Wk, dims=([0, 2], [0, 1]))      # (a_ket, A, n_in, w')
    return torch.tensordot(t2, xk_ket, dims=([0, 2], [0, 1]))  # (A, w', A_ket)


def _env_right_op(R, xk_bra, Wk, xk_ket):
    """R (b_bra, w, b_ket) extended leftwards."""
    t1 = torch.tensordot(xk_bra.conj(), R, dims=([2], [0]))  # (A, n, w, b_ket)
    t2 = torch.tensordot(Wk, t1, dims=([1, 3], [1, 2]))      # (w_l, n_in, A, b_ket)
    t3 = torch.tensordot(t2, xk_ket, dims=([1, 3], [1, 2]))  # (w_l, A, B_ket)
    return t3.permute(1, 0, 2)                               # (A_bra, w_l, B_ket)


def _env_left_rhs(Lb, xk_bra, bk):
    """Lb (a_bra, c) extended by <x|b> one site."""
    t1 = torch.tensordot(Lb, xk_bra.conj(), dims=([0], [0]))  # (c, n, A)
    return torch.tensordot(t1, bk, dims=([0, 1], [0, 1]))     # (A, c')


def _env_right_rhs(Rb, xk_bra, bk):
    t1 = torch.tensordot(xk_bra.conj(), Rb, dims=([2], [0]))  # (A, n, c)
    return torch.tensordot(t1, bk, dims=([1, 2], [1, 2]))     # (A, C)


def _heff(L, W1, W2, R, v):
    """H_eff applied to the two-site tensor v (Dl, n1, n2, Dr)."""
    t = torch.tensordot(L, v, dims=([2], [0]))           # (a_bra, w, n1, n2, Dr)
    t = torch.tensordot(t, W1, dims=([1, 2], [0, 2]))    # (a_bra, n2, Dr, m1, w')
    t = torch.tensordot(t, W2, dims=([4, 1], [0, 2]))    # (a_bra, Dr, m1, m2, w'')
    return torch.tensordot(t, R, dims=([4, 1], [1, 2]))  # (a_bra, m1, m2, b_bra)


def _local_matvec(L, W1, W2, R, v, sigma, sign):
    """Apply sign*(sigma*I - H_eff) to the two-site tensor v
    (Dl, n1, n2, Dr)."""
    return sign * (sigma * v - _heff(L, W1, W2, R, v))


def _local_rhs(Lb, b1, b2, Rb):
    """Project the RHS onto the two-site basis: (Dl, n1, n2, Dr)."""
    t = torch.tensordot(Lb, b1, dims=([1], [0]))          # (A, n1, c)
    t = torch.tensordot(t, b2, dims=([2], [0]))           # (A, n1, n2, c')
    return torch.tensordot(t, Rb, dims=([3], [1]))        # (A, n1, n2, B)


def _split_two_site(theta, maxD: Optional[int], eps: float):
    """SVD-split a solved two-site tensor; returns (left (Dl,n1,k),
    right (k,n2,Dr)) with the singular values absorbed right."""
    Dl, n1, n2, Dr = theta.shape
    u, s, vh = svd(theta.reshape(Dl * n1, n2 * Dr))
    keep, _ = keep_count(s, maxD, eps)
    u = u[:, :keep]
    sv = s[:keep, None].to(vh.dtype) * vh[:keep]
    return u.reshape(Dl, n1, keep), sv.reshape(keep, n2, Dr)


def _right_canonicalize(x):
    """Right-to-left QR sweep (center at site 0), in place on the list."""
    for k in range(len(x) - 1, 0, -1):
        Dl, n, Dr = x[k].shape
        q, r = torch.linalg.qr(x[k].reshape(Dl, n * Dr).conj().T)
        x[k] = q.conj().T.reshape(q.shape[1], n, Dr)
        x[k - 1] = torch.tensordot(x[k - 1], r.conj().T, dims=([2], [0]))


def _move_right(x, k, left, right):
    """Store a split with site k left-orthonormal (QR), R absorbed right."""
    Dl, n1, kk = left.shape
    q, r = torch.linalg.qr(left.reshape(Dl * n1, kk))
    x[k] = q.reshape(Dl, n1, q.shape[1])
    x[k + 1] = torch.tensordot(r, right, dims=([1], [0]))


def _move_left(x, k, left, right):
    """Store a split with site k+1 right-orthonormal, R absorbed left."""
    kk, n2, Dr = right.shape
    q, r = torch.linalg.qr(right.reshape(kk, n2 * Dr).conj().T)
    x[k + 1] = q.conj().T.reshape(q.shape[1], n2, Dr)
    x[k] = torch.tensordot(left, r.conj().T, dims=([2], [0]))


def _ones(shape, dtype, device):
    return torch.ones(shape, dtype=dtype, device=device)


# ----------------------------------------------------------------------------
# DMRG eigensweep
# ----------------------------------------------------------------------------
def dmrg_eigensolve(mpo_tensors, dims: List[int], x0=None, nStates: int = 1,
                    maxD: Optional[int] = 32, eps: float = 1e-10,
                    nSweep: int = 30, convTol: float = 1e-9,
                    seed: int = 0, dtype=np.float64, device=None):
    """Two-site DMRG eigensweep: lowest ``nStates`` eigenpairs of the MPO.

    Fills the guess-generation role of the reference's external
    ``ttns2.eigenStateComputations`` DMRG runs (reference:
    unittests/test_feast_ttns.py:64-73).  Excited states are obtained by
    deflation: each subsequent state is optimized in the complement of the
    previous ones (hard projection in the local problem).  Runs on the
    device of the MPO tensors (numpy tensors go to ``device``, default the
    card).

    :returns: (energies list, list of MPS tensor-lists)
    """
    W = to_tensors(mpo_tensors, device, dtype)
    energies, states = [], []
    for istate in range(nStates):
        e, x = _dmrg_one_state(W, dims, x0 if istate == 0 else None,
                               states, maxD, eps, nSweep, convTol,
                               seed + istate, torch_dtype(dtype))
        energies.append(e)
        states.append(x)
    return energies, states


def _dmrg_one_state(W, dims, x0, lower_states, maxD, eps, nSweep, convTol,
                    seed, dtype):
    dev = W[0].device
    Lsites = len(dims)
    if x0 is not None:
        x = to_tensors(x0, dev, dtype)
    else:
        x = mps_random(dims, maxD or 8, seed=seed,
                       dtype=numpy_dtype(dtype), device=dev)

    if Lsites == 1:
        ev, uv = torch.linalg.eigh(W[0][0, :, :, 0])
        return float(ev[0]), [uv[:, 0].reshape(1, dims[0], 1)]

    _right_canonicalize(x)
    x[0] = x[0] / np.sqrt(abs(mps_vdot(x, x)))

    Lop = [None] * (Lsites + 1)
    Rop = [None] * (Lsites + 1)
    Lop[0] = _ones((1, 1, 1), dtype, dev)
    Rop[Lsites - 1] = _ones((1, 1, 1), dtype, dev)
    for k in range(Lsites - 1, 1, -1):
        Rop[k - 1] = _env_right_op(Rop[k], x[k], W[k], x[k])

    # deflation environments against previously found states
    penv = []
    for s in lower_states:
        Lp = [None] * (Lsites + 1)
        Rp = [None] * (Lsites + 1)
        Lp[0] = _ones((1, 1), dtype, dev)
        Rp[Lsites - 1] = _ones((1, 1), dtype, dev)
        for k in range(Lsites - 1, 1, -1):
            Rp[k - 1] = _env_right_rhs(Rp[k], x[k], s[k])
        penv.append((s, Lp, Rp))
    penalty = 100.0 * max(1.0, max(float(w.abs().max()) for w in W))

    def solve_pair(k, theta0, tol):
        shape = tuple(theta0.shape)
        Lk, Rk = Lop[k], Rop[k + 1]
        defl = Deflation([_local_rhs(Lp[k], s[k], s[k + 1], Rp[k + 1])
                          for s, Lp, Rp in penv], penalty)
        theta0 = defl.start(theta0, k)
        apply = defl.wrap(lambda v: _heff(Lk, W[k], W[k + 1], Rk,
                                          v.reshape(shape)).reshape(-1))
        return local_eigen(apply, theta0, tol, dtype,
                           deflated=defl.D is not None)

    energy = None
    e = None
    for sweep in range(nSweep):
        # local-solve tolerance schedule: loose while the state is far from
        # converged, tight for the final refinement sweeps
        loc_tol = 1e-4 if sweep < 2 else max(convTol * 1e-2, 1e-11)
        for k in range(Lsites - 1):
            theta0 = torch.tensordot(x[k], x[k + 1], dims=([2], [0]))
            e, theta = solve_pair(k, theta0, loc_tol)
            _move_right(x, k, *_split_two_site(theta, maxD, eps))
            Lop[k + 1] = _env_left_op(Lop[k], x[k], W[k], x[k])
            for s, Lp, Rp in penv:
                Lp[k + 1] = _env_left_rhs(Lp[k], x[k], s[k])
        for k in range(Lsites - 2, -1, -1):
            theta0 = torch.tensordot(x[k], x[k + 1], dims=([2], [0]))
            e, theta = solve_pair(k, theta0, loc_tol)
            _move_left(x, k, *_split_two_site(theta, maxD, eps))
            Rop[k] = _env_right_op(Rop[k + 1], x[k + 1], W[k + 1], x[k + 1])
            for s, Lp, Rp in penv:
                Rp[k] = _env_right_rhs(Rp[k + 1], x[k + 1], s[k + 1])
        if energy is not None and e is not None and \
                abs(e - energy) <= convTol * max(1.0, abs(e)):
            energy = e
            break
        energy = e

    # normalize (center at site 0 after the right-to-left pass)
    x[0] = x[0] / np.sqrt(abs(mps_vdot(x, x)))
    return energy, x


# ----------------------------------------------------------------------------
# ALS linear-system solver
# ----------------------------------------------------------------------------
def _sweep_change(prev, x, vdot):
    """Relative change of the solution between sweeps (overlap based)."""
    nrm2 = abs(vdot(x, x))
    ovlp = abs(vdot(prev, x))
    denom = np.sqrt(abs(vdot(prev, prev)) * nrm2)
    return np.sqrt(max(0.0, 1.0 - (ovlp / denom) ** 2)) if denom > 0 else 1.0


def als_solve(mpo_tensors, b, sigma, x0=None, sign: float = 1.0,
              maxD: Optional[int] = 64, eps: float = 1e-10,
              nSweep: int = 20, convTol: float = 1e-6,
              local_tol: float = 1e-8, local_maxiter: int = 200,
              dtype=None, device=None):
    """Solve sign*(sigma*I - H) x = b by two-site ALS sweeps.

    :param mpo_tensors: MPO of H, site tensors (Wl, n_out, n_in, Wr)
    :param b: RHS MPS (tensors on the solve's device; numpy tensors go to
        ``device``, default the card)
    :param x0: initial guess (default: copy of b, reference convention
        ttnsVector.py:173-176)
    :param convTol: sweep convergence on the relative change of x between
        sweeps (overlap-based)
    :returns: solution MPS (bonds adapted by SVD)
    """
    b = to_tensors(b, device)
    dev = b[0].device
    sigma = sigma.item() if hasattr(sigma, "item") else sigma
    dtype = torch_dtype(dtype) if dtype is not None else result_type(
        torch_dtype(np.asarray(sigma).dtype), *b, *mpo_tensors)
    Lsites = len(b)
    x = to_tensors(x0 if x0 is not None else b, dev, dtype)
    b = [t.to(dtype) for t in b]
    W = to_tensors(mpo_tensors, dev, dtype)

    if Lsites == 1:
        # single site: dense solve in the full (tiny) space
        n = x[0].shape[1]
        A = sign * (sigma * torch.eye(n, dtype=dtype, device=dev)
                    - W[0][0, :, :, 0])
        return [torch.linalg.solve(A, b[0][0, :, 0]).reshape(1, n, 1)]

    _right_canonicalize(x)

    # environments: Lop[k] covers sites < k; Rop[k] covers sites > k
    Lop = [None] * (Lsites + 1)
    Rop = [None] * (Lsites + 1)
    Lb_ = [None] * (Lsites + 1)
    Rb_ = [None] * (Lsites + 1)
    Lop[0] = _ones((1, 1, 1), dtype, dev)
    Rop[Lsites - 1] = _ones((1, 1, 1), dtype, dev)
    Lb_[0] = _ones((1, 1), dtype, dev)
    Rb_[Lsites - 1] = _ones((1, 1), dtype, dev)
    for k in range(Lsites - 1, 1, -1):
        Rop[k - 1] = _env_right_op(Rop[k], x[k], W[k], x[k])
        Rb_[k - 1] = _env_right_rhs(Rb_[k], x[k], b[k])

    def solve_pair(k, theta0):
        Lk, Rk = Lop[k], Rop[k + 1]
        rhs = _local_rhs(Lb_[k], b[k], b[k + 1], Rb_[k + 1])
        return local_solve(
            lambda v: _local_matvec(Lk, W[k], W[k + 1], Rk, v, sigma, sign),
            rhs, theta0, local_tol, local_maxiter, dtype)

    prev = None
    for sweep in range(nSweep):
        for k in range(Lsites - 1):                     # left -> right
            theta0 = torch.tensordot(x[k], x[k + 1], dims=([2], [0]))
            theta = solve_pair(k, theta0)
            _move_right(x, k, *_split_two_site(theta, maxD, eps))
            Lop[k + 1] = _env_left_op(Lop[k], x[k], W[k], x[k])
            Lb_[k + 1] = _env_left_rhs(Lb_[k], x[k], b[k])
        for k in range(Lsites - 2, -1, -1):             # right -> left
            theta0 = torch.tensordot(x[k], x[k + 1], dims=([2], [0]))
            theta = solve_pair(k, theta0)
            _move_left(x, k, *_split_two_site(theta, maxD, eps))
            Rop[k] = _env_right_op(Rop[k + 1], x[k + 1], W[k + 1], x[k + 1])
            Rb_[k] = _env_right_rhs(Rb_[k + 1], x[k + 1], b[k + 1])
        if prev is not None and _sweep_change(prev, x, mps_vdot) < convTol:
            break
        prev = list(x)
    return x
