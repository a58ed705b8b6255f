"""TorchVector — the dense torch backend of the AbstractVector contract.

Role parity with the reference's dense backend (reference: numpyVector.py)
and with the JAX package's ``JaxVector``:

* subspace assembly (overlap / operator matrices) is formulated as (m, n)
  matrix products instead of m^2 host-looped dots
  (reference: numpyVector.py:180-203 loops vdots);
* shifted solves run the solvers of
  :mod:`eigensolvers_tpu_torch.ops.linear_solvers` on the vector's device
  (MINRES, GMRES or exact), with a batched lane-stack path
  (:meth:`TorchVector.solveBatch`) for block Lanczos, and the
  split-complex lane path (:meth:`TorchVector.solveBatchSplit`) with the
  quadrature sums for FEAST's contour solves.

All products run at true fp32/fp64 (TF32 refused, see
:func:`~eigensolvers_tpu_torch.ops.operators.require_true_fp32`): the
Rayleigh-Ritz and lindep thresholds cannot afford a TF32 floor.

The small m×m matrices are returned as host numpy arrays: the projected
eigenproblems are solved on the host (LAPACK), the right place for
~100×100 problems.

Hooks for the sharded backend (:class:`~eigensolvers_tpu_torch.parallel.
ShardedVector`, which holds a block of the state's rows on each rank):
every contraction over the state axis goes through :meth:`_reducer` (no
reduction here, the all-reduce over "x" there), new vectors are made
laid out like an existing one (:meth:`_like`), the tall QR of a stacked
basis is :meth:`_tall_qr`, and batched solves run their lane stack through
:meth:`_batched` after padding it to :meth:`_batch_lane_pad` lanes.
"""

from __future__ import annotations

import functools
import math
import warnings
from typing import List, Optional

import numpy as np
import torch

from .abstract import AbstractVector, LINDEP_DEFAULT_VALUE
from ..config import normalize_options
from ..ops.operators import as_operator, as_tensor, require_true_fp32
from ..ops import linear_solvers as ls
from ..utils.profiling import span, to_host


def _mm(a, b):
    require_true_fp32(a)
    return a @ b


def _mgs(x, Q, reduce=None):
    """Sequential (modified) Gram-Schmidt of x against the rows of Q.

    For real data the dots are non-conjugated — a deliberate reproduction of
    the reference quirk (reference: numpyVector.py:133-140), which is
    identical to standard GS there.  For complex data that quirk is wrong
    (it does not orthogonalize against the Hermitian inner product), so
    complex inputs use conjugated dots.

    Returns (x_orth, innerprod) with innerprod = <x, x> (Hermitian for
    complex, plain for real — both real-valued for the lindep test).  Under
    ``reduce`` (sharded rows) each q costs one all-reduce of its two dots."""
    complex_data = x.is_complex() or Q.is_complex()
    for q in Q:
        if complex_data:
            term1 = torch.vdot(q, x)
            term2 = torch.vdot(q, q).real
        else:
            term1 = torch.dot(x, q)
            term2 = torch.dot(q, q)
        if reduce is not None:
            term1, term2 = reduce(torch.stack([term1,
                                               term2.to(term1.dtype)]))
            term2 = term2.real
        denom = torch.where(torch.abs(term2) > 0, term2, 1.0)
        x = x - (term1 / denom) * q
    if complex_data:
        return x, ls.reduced(torch.vdot(x, x).real, reduce)
    return x, ls.reduced(torch.dot(x, x), reduce)


class TorchVector(AbstractVector):
    """Dense state vector backed by a torch tensor (any tensor shape;
    treated as a flat vector by the inner products).  A numpy ``array`` is
    placed on ``device`` (default: the card, which must exist; pass
    ``device="cpu"`` for the CPU); a tensor stays where it is unless
    ``device`` is given."""

    def __init__(self, array, options: Optional[dict] = None, device=None):
        self.array = as_tensor(array, device)
        options = normalize_options(options)
        # Same option surface and defaults as the reference dense backend
        # (reference: numpyVector.py:29-36).
        opt = dict(options.get("linearSystemArgs", {}))
        opt.setdefault("linearSolver", "minres")
        opt.setdefault("linearIter", 1000)
        opt.setdefault("linear_tol", 1e-4)
        opt.setdefault("linear_atol", 1e-4)
        opt.setdefault("gmresRestart", 30)
        # Optional inner-solve preconditioning (None | "jacobi"); a framework
        # extension — the reference's scipy solvers were run unpreconditioned.
        opt.setdefault("preconditioner", None)
        # Reference escalates solver non-convergence warnings to errors
        # (reference: numpyVector.py:175-177).
        opt.setdefault("errorOnNonConvergence", True)
        options["linearSystemArgs"] = opt
        self.options = options

    # -- properties ---------------------------------------------------------
    @property
    def hasExactAddition(self) -> bool:
        return True

    @property
    def dtype(self) -> torch.dtype:
        return self.array.dtype

    @property
    def device(self) -> torch.device:
        return self.array.device

    @property
    def maxD(self) -> int:
        return 0  # uncompressed

    @property
    def size(self) -> int:
        return self.array.numel()

    @property
    def shape(self):
        return tuple(self.array.shape)

    # -- backend hooks (overridden by the sharded backend) ------------------
    def _like(self, array, options=None) -> "TorchVector":
        """A vector of this kind holding ``array``, laid out as this one's
        (for a sharded vector: this rank's rows of the same mesh)."""
        return type(self)(array, self.options if options is None else options)

    @classmethod
    def _reducer(cls, ref):
        """The reduction of a contraction over the state axis of vectors
        like ``ref``: None here, where each vector is whole."""
        return None

    @classmethod
    def _tall_qr(cls, A, ref):
        """Reduced QR of the tall (n, m) stack of vectors like ``ref``."""
        return torch.linalg.qr(A, mode="reduced")

    @classmethod
    def _batched(cls, solve, op, B, sigmas, X0, ref):
        """Run ``solve(op, B, sigmas, X0, reduce)`` on a lane stack of
        vectors like ``ref``: here at once, on the whole stack."""
        return solve(op, B, sigmas, X0, None)

    @classmethod
    def _batch_lane_pad(cls, nlanes: int, ref) -> int:
        """Zero lanes to append so the batch divides the mesh's "b" extent
        (0 here).  A padding lane's solve finishes at once."""
        return 0

    @classmethod
    def _place_batch(cls, B, ref, state_axis: int = 1):
        """This process's lanes of a stacked solve batch: all of them
        here."""
        return B

    # -- scalar ops ---------------------------------------------------------
    def __mul__(self, other):
        return self._like(self.array * other)

    def __rmul__(self, other):
        return self._like(self.array * other)

    def __truediv__(self, other):
        return self._like(self.array / other)

    def __imul__(self, other):
        self.array = self.array * other
        return self

    def __itruediv__(self, other):
        self.array = self.array / other
        return self

    def __len__(self) -> int:
        return int(self.array.numel())

    def _norm_t(self) -> torch.Tensor:
        n = torch.linalg.vector_norm(self.array)
        red = self._reducer(self)
        return n if red is None else red(n, "norm")

    def normalize(self) -> "TorchVector":
        self.array = self.array / self._norm_t()
        return self

    def norm(self) -> float:
        return float(to_host(self._norm_t()))

    def real(self) -> "TorchVector":
        return self._like(torch.real(self.array))

    def conjugate(self) -> "TorchVector":
        return self._like(torch.conj_physical(self.array))

    def vdot(self, other, conjugate: bool = True):
        dtype = torch.promote_types(self.dtype, other.dtype)
        a = self.array.reshape(-1).to(dtype)
        b = other.array.reshape(-1).to(dtype)
        val = torch.vdot(a, b) if conjugate else torch.dot(a, b)
        val = to_host(ls.reduced(val, self._reducer(self)))
        return complex(val) if val.is_complex() else float(val)

    def copy(self) -> "TorchVector":
        return self._like(self.array.clone())

    @classmethod
    def _as_operator(cls, H, ref: "TorchVector"):
        """Coerce H for application to ``ref``-shaped vectors; a numpy or
        scipy H is placed on ``ref``'s device."""
        return as_operator(H, device=ref.device)

    def applyOp(self, operator) -> "TorchVector":
        op = self._as_operator(operator, self)
        return self._like(op.matvec(self.array))

    def compress(self) -> "TorchVector":
        return self

    def to_state_dict(self) -> dict:
        return {"kind": np.asarray("dense"),
                "array": self.array.detach().cpu().numpy()}

    @classmethod
    def from_state_dict(cls, state: dict, options=None, device=None):
        """Rebuild from :meth:`to_state_dict` output — also the dict the JAX
        package's ``JaxVector.to_state_dict`` writes."""
        kind = str(state.get("kind", "dense"))
        if kind != "dense":
            raise ValueError(f"not a dense vector state: kind={kind!r}")
        return cls(state["array"], options, device=device)

    # -- stacked-basis helpers ----------------------------------------------
    @staticmethod
    def _stack(vectors: List["TorchVector"],
               pad_to: Optional[int] = None) -> torch.Tensor:
        """The (m, n) stack of the vectors' flat arrays at their common
        dtype, with zero rows appended up to ``pad_to``."""
        dtype = functools.reduce(torch.promote_types,
                                 [v.dtype for v in vectors])
        V = torch.stack([v.array.reshape(-1).to(dtype) for v in vectors])
        if pad_to is not None and pad_to > V.shape[0]:
            V = torch.cat([V, V.new_zeros((pad_to - V.shape[0], V.shape[1]))])
        return V

    @staticmethod
    def _coeffs(coeffs, V) -> torch.Tensor:
        c = torch.as_tensor(np.asarray(coeffs))
        dtype = torch.promote_types(V.dtype, c.dtype)
        return c.to(device=V.device, dtype=dtype)

    # -- collective ops -----------------------------------------------------
    @classmethod
    def linearCombination(cls, vectors: List["TorchVector"],
                          coeffs) -> "TorchVector":
        assert len(vectors) == len(coeffs)
        V = cls._stack(vectors)
        c = cls._coeffs(coeffs, V)
        out = _mm(c, V.to(c.dtype))
        return vectors[0]._like(out.reshape(vectors[0].array.shape))

    @classmethod
    def linearCombinationBatch(cls, vectors: List["TorchVector"],
                               coeffs) -> List["TorchVector"]:
        """All k combinations of an (m, k) coefficient matrix in one matrix
        product — the fast path under basisTransformation's 2-D case."""
        coeffs = np.asarray(coeffs)
        assert coeffs.ndim == 2 and len(vectors) == coeffs.shape[0]
        V = cls._stack(vectors)
        C = cls._coeffs(coeffs, V)
        out = _mm(C.T, V.to(C.dtype))
        shape = vectors[0].array.shape
        return [vectors[0]._like(out[j].reshape(shape))
                for j in range(out.shape[0])]

    @classmethod
    def orthogonalize(cls, xs: List["TorchVector"],
                      lindep=LINDEP_DEFAULT_VALUE) -> List["TorchVector"]:
        """Orthonormalize the whole set (contract method,
        reference: abstractVector.py:112, util_funcs.py:170-194 `_qr`):
        one QR of the stacked (n, m) tall matrix; columns whose residual
        against the preceding ones has squared norm <= ``lindep`` are
        dropped (rank-revealed by |diag R|, then re-factored so the
        returned set is exactly orthonormal)."""
        keep = list(range(len(xs)))
        shape = xs[0].array.shape
        for _ in range(len(xs)):  # ≥1 drop per pass → terminates
            V = cls._stack([xs[i] for i in keep])
            Q, R = cls._tall_qr(V.T, xs[0])
            d = to_host(torch.abs(torch.diagonal(R))).numpy()
            ok = d * d > lindep
            if ok.all():
                Qh = Q.T
                return [xs[keep[j]]._like(Qh[j].reshape(shape))
                        for j in range(len(keep))]
            keep = [keep[j] for j in range(len(keep)) if ok[j]]
            if not keep:
                return []
        return []  # pragma: no cover

    @classmethod
    def orthogonalize_against_set(cls, x: "TorchVector",
                                  qs: List["TorchVector"],
                                  lindep=LINDEP_DEFAULT_VALUE):
        Q = cls._stack(qs)
        # promote, never demote: casting a complex x to a real basis dtype
        # would silently drop its imaginary part
        dtype = torch.promote_types(x.dtype, Q.dtype)
        arr, innerprod = _mgs(x.array.reshape(-1).to(dtype), Q.to(dtype),
                              cls._reducer(x))
        innerprod = float(to_host(innerprod))
        if innerprod > lindep:
            arr = arr / math.sqrt(innerprod)
            return x._like(arr.reshape(x.array.shape))
        return None

    @classmethod
    def overlapMatrix(cls, vectors: List["TorchVector"]) -> np.ndarray:
        V = cls._stack(vectors)
        return to_host(ls.reduced(_mm(V.conj(), V.T),
                                  cls._reducer(vectors[0]))).numpy()

    @classmethod
    def matrixRepresentation(cls, operator,
                             vectors: List["TorchVector"]) -> np.ndarray:
        op = cls._as_operator(operator, vectors[0])
        V = cls._stack(vectors)
        AV = op.matmat(V.T)                                  # (n, m)
        return to_host(ls.reduced(_mm(V.conj(), AV.to(V.dtype)),
                                  cls._reducer(vectors[0]))).numpy()

    @classmethod
    def extendOverlapMatrix(cls, vectors: List["TorchVector"],
                            overlap: np.ndarray) -> np.ndarray:
        V = cls._stack(vectors)
        col = to_host(ls.reduced(_mm(V.conj(), V[-1]),  # <v_i | v_new>
                                 cls._reducer(vectors[0]))).numpy()
        overlap = np.append(overlap, col[None, :-1].conj(), axis=0)
        overlap = np.append(overlap, col[:, None], axis=1)
        return overlap

    @classmethod
    def extendMatrixRepresentation(cls, operator, vectors: List["TorchVector"],
                                   opMat: np.ndarray) -> np.ndarray:
        op = cls._as_operator(operator, vectors[0])
        V = cls._stack(vectors)
        Hket = op.matvec(V[-1]).to(V.dtype)
        col = to_host(ls.reduced(_mm(V.conj(), Hket),   # <v_i | A v_new>
                                 cls._reducer(vectors[0]))).numpy()
        opMat = np.append(opMat, col[None, :-1].conj(), axis=0)
        opMat = np.append(opMat, col[:, None], axis=1)
        return opMat

    # -- FEAST quadrature ---------------------------------------------------
    @classmethod
    def _accumulate_quadrature(cls, sols, mults, m0: int):
        """FEAST: Q[i] = Re sum_k mults[k] * sols[k*m0 + i], one
        contraction.  The complex128 multipliers promote the sum to f64 on
        purpose: the filtered subspace is carried in f64 (see
        :meth:`_accumulate_quadrature_split`)."""
        S = torch.stack([s.array.reshape(-1) for s in sols])
        m = torch.as_tensor(np.asarray(mults, np.complex128), device=S.device)
        out = torch.real(torch.tensordot(
            m, S.to(m.dtype).reshape(len(mults), m0, -1), dims=([0], [0])))
        shape = sols[0].array.shape
        return [sols[0]._like(out[i].reshape(shape)) for i in range(m0)]

    @classmethod
    def _accumulate_quadrature_split(cls, sols, mults, m0: int, options=None,
                                     ref=None):
        """FEAST after split-complex solves: ``sols`` are raw (2, n)
        (Re, Im) tensors, and out[i] = sum_k Re(mult_k) Re(x_ki) -
        Im(mult_k) Im(x_ki) in real arithmetic.  The f64 multipliers
        DELIBERATELY promote the subspace to f64 (mixed precision, shared
        with the fused loop, solvers/fast_feast.py): the f32 contour solves
        act as inexact-FEAST noise that the f64 Rayleigh-Ritz step averages
        down; an all-f32 outer iteration stalls at ~1e-3 eigenvalue error."""
        S = torch.stack(sols).to(torch.float64)            # (nk*m0, 2, n)
        S = S.reshape(len(mults), m0, 2, -1)
        mults = np.asarray(mults)
        mre = torch.as_tensor(mults.real, dtype=torch.float64, device=S.device)
        mim = torch.as_tensor(mults.imag, dtype=torch.float64, device=S.device)
        out = (torch.tensordot(mre, S[:, :, 0], dims=([0], [0]))
               - torch.tensordot(mim, S[:, :, 1], dims=([0], [0])))
        if ref is None:
            return [cls(out[i], options) for i in range(m0)]
        return [ref._like(out[i], options) for i in range(m0)]

    @classmethod
    def solveBatchSplit(cls, H, bs, sigmas, x0s=None, reverseGF: bool = False,
                        rtol_scale: float = 1.0, report=None):
        """Batched complex-shifted solves of a REAL operator in real
        arithmetic (split-complex J-symmetrized MINRES, FEAST's contour
        solves): one lane per (sigma_k, b_k), every MINRES pass one apply
        of the whole lane stack.  ``x0s`` warm starts: a list of vectors
        with real (n,) arrays, or a raw (nlanes, 2, n) split-guess stack
        (Re, Im — FEAST's Ritz warm starts).  ``linearSystemArgs
        ["batchChunk"]`` bounds the simultaneous lanes; chunks run one
        after another.  A caller's ``report`` accumulates "iterations", and
        the ``linearSystemArgs["report"]`` dict "solves", "iterations" and
        "matmats" (stack applies).  A lane that does not converge raises,
        or warns under ``errorOnNonConvergence=False``.  Returns raw (2, n)
        tensors (Re x, Im x), one per lane."""
        opts = bs[0].options["linearSystemArgs"]
        chunk = opts.get("batchChunk")
        if chunk and len(bs) > chunk:
            out = []
            for i in range(0, len(bs), chunk):
                out.extend(cls.solveBatchSplit(
                    H, bs[i:i + chunk], sigmas[i:i + chunk],
                    x0s=None if x0s is None else x0s[i:i + chunk],
                    reverseGF=reverseGF, rtol_scale=rtol_scale,
                    report=report))
            return out
        with span("es.linear.solve"):
            op = cls._as_operator(H, bs[0])
            B = torch.stack([b.array.reshape(-1) for b in bs])
            if B.is_complex():
                raise ValueError(
                    "split-complex solves need real right-hand sides")
            if x0s is None:
                X0 = None
            elif isinstance(x0s, (list, tuple)):
                X0 = torch.stack([x.array.reshape(-1) for x in x0s])
            else:
                X0 = as_tensor(x0s, B.device)
            nl = len(bs)
            B, sig, X0 = cls._pad_lanes(B, list(sigmas), X0, bs[0])
            res = cls._batched(
                lambda o, Bl, s, X0l, red: ls.gmres_splitc_batch(
                    o, Bl, s, x0s=X0l, rtol=opts["linear_tol"] * rtol_scale,
                    atol=opts["linear_atol"] * rtol_scale,
                    restart=opts["gmresRestart"], maxiter=opts["linearIter"],
                    reverseGF=reverseGF, precond=opts.get("preconditioner"),
                    escalate=int(opts.get("escalateIter", 3)), reduce=red),
                op, B, sig, X0, bs[0])
            res = _first_lanes(res, nl)
            cls._account(opts, report, "minres", res, len(bs))
            for k, ok in enumerate(res.converged):
                if not ok:
                    msg = (f"Batched split solver lane {k} did not converge: "
                           f"residual {float(res.resnorm[k]):.3e} after "
                           f"{int(res.iterations[k])} iterations")
                    if opts.get("errorOnNonConvergence", True):
                        raise RuntimeError(msg)
                    warnings.warn(msg)
            return list(res.x)

    # -- linear solves ------------------------------------------------------
    @staticmethod
    def _solve_dtype(op, sigma, *vec_dtypes) -> torch.dtype:
        """Solve dtype: the DATA (operator/vector) dtype decides precision;
        the shift only decides complexness (a Python complex sigma must not
        upcast an f32 problem to c128)."""
        base = functools.reduce(torch.promote_types, [op.dtype, *vec_dtypes])
        if np.iscomplexobj(np.asarray(sigma)):
            return torch.promote_types(base, torch.complex64)
        return base

    @staticmethod
    def _solve_opts(b: "TorchVector", sigma, opType):
        opts = b.options["linearSystemArgs"]
        solver = opts["linearSolver"]
        aliases = {"gcrotmk": "gmres", "pardiso": "exact"}
        solver = aliases.get(solver, solver)
        hermitian = opType in ("her", "pos") and \
            not np.iscomplexobj(np.asarray(sigma))
        # MINRES requires a Hermitian system; a complex shift or a declared
        # general operator must fall through to GMRES.
        if solver == "minres" and not hermitian:
            solver = "gmres"
        # Conversely, restarted GMRES stagnates on strongly indefinite
        # Hermitian systems: for Hermitian systems with a real shift, MINRES
        # is the optimal short-recurrence method; the contract is the
        # stopping tolerance, not the solver internals.
        if solver == "gmres" and hermitian:
            solver = "minres"
        return solver, opts

    @classmethod
    def _pad_lanes(cls, B, sigmas, X0, ref):
        """Zero lanes appended to the stack B (and to the warm starts X0),
        with copies of the first shift, to :meth:`_batch_lane_pad`."""
        pad = cls._batch_lane_pad(B.shape[0], ref)
        if not pad:
            return B, sigmas, X0
        sig = np.asarray(sigmas)
        sig = np.concatenate([sig.ravel(), np.repeat(sig.ravel()[:1], pad)])
        B = torch.cat([B, B.new_zeros((pad,) + tuple(B.shape[1:]))])
        if X0 is not None:
            X0 = torch.cat([X0, X0.new_zeros((pad,) + tuple(X0.shape[1:]))])
        return B, sig, X0

    @classmethod
    def _split_single(cls, op, b, sigma, x0, opts, reverseGF):
        """One complex-shifted solve of a real symmetric operator via the
        J-symmetrized real-block MINRES (one lane of
        :func:`~eigensolvers_tpu_torch.ops.linear_solvers.gmres_splitc_batch`),
        recombined to a complex result: restarted GMRES stagnates on these
        spectra, the split MINRES has conditioning ~|sigma - lam|."""
        B = b.array.reshape(1, -1)
        X0 = None if x0 is None else torch.real(x0.array).reshape(1, -1)
        res = ls.gmres_splitc_batch(
            op, B, [complex(sigma)], x0s=X0,
            rtol=opts["linear_tol"], atol=opts["linear_atol"],
            maxiter=opts["linearIter"], reverseGF=reverseGF,
            precond=opts.get("preconditioner"),
            escalate=int(opts.get("escalateIter", 3)),
            reduce=cls._reducer(b))
        cls._account(opts, None, "minres", res, 1)
        if not res.converged[0]:
            msg = (f"Iterative solver splitc-minres did not converge: "
                   f"residual {float(res.resnorm[0]):.3e} after "
                   f"{int(res.iterations[0])} iterations")
            if opts.get("errorOnNonConvergence", True):
                raise RuntimeError(msg)
            warnings.warn(msg)
        x = torch.complex(res.x[0, 0], res.x[0, 1])
        return b._like(x.reshape(b.array.shape))

    @classmethod
    def _want_split(cls, op, b, sigma, opts):
        """Whether the JAX package would take its split-complex path here:
        a complex shift on a real operator and real RHS (not an exact
        solve; ``linearSystemArgs["splitComplex"]`` overrides)."""
        if not np.iscomplexobj(np.asarray(sigma)):
            return False
        if b.dtype.is_complex or op.dtype.is_complex:
            return False
        if opts.get("linearSolver") in ("exact", "pardiso"):
            return False
        forced = opts.get("splitComplex")
        return True if forced is None else bool(forced)

    @staticmethod
    def _account(opts, report, solver, res, nlanes):
        """Add a solve's counts to the ``linearSystemArgs["report"]`` dict
        and to a caller's ``report``: "solves", "iterations" (summed over
        lanes), and the operator applies — "matvecs" for single vectors,
        "matmats" for lane stacks (batched MINRES)."""
        its = int(np.sum(res.iterations))
        applies = "matmats" if nlanes and solver == "minres" else "matvecs"
        shared = opts.get("report")
        if shared is not None:
            for key, val in (("solves", max(nlanes, 1)), ("iterations", its),
                             (applies, res.matvecs)):
                shared[key] = shared.get(key, 0) + val
        if report is not None:
            report["iterations"] = report.get("iterations", 0) + its

    @classmethod
    def solve(cls, H, b: "TorchVector", sigma, x0=None, opType: str = "her",
              reverseGF: bool = False) -> "TorchVector":
        """(sigma*I - H) x = b, inexactly (reference: numpyVector.py:147-178).

        A dict under ``options["linearSystemArgs"]["report"]`` (shared by
        every vector derived from the one that carries it) accumulates
        "solves", "iterations" and "matvecs" over all solves."""
        with span("es.linear.solve"):
            solver, opts = cls._solve_opts(b, sigma, opType)
            op = cls._as_operator(H, b)
            if cls._want_split(op, b, sigma, opts):
                return cls._split_single(op, b, sigma, x0, opts, reverseGF)
            dtype = cls._solve_dtype(op, sigma, b.dtype)
            barr = b.array.reshape(-1).to(dtype)
            x0arr = None if x0 is None else x0.array.reshape(-1).to(dtype)
            red = cls._reducer(b)
            if solver == "exact":
                res = ls.solve_exact(op, barr, sigma, reverseGF=reverseGF)
            elif solver == "minres":
                res = ls.minres(op, barr, sigma, x0=x0arr,
                                rtol=opts["linear_tol"],
                                atol=opts["linear_atol"],
                                maxiter=opts["linearIter"],
                                reverseGF=reverseGF,
                                precond=opts.get("preconditioner"),
                                reduce=red)
            elif solver == "gmres":
                res = ls.gmres(op, barr, sigma, x0=x0arr,
                               rtol=opts["linear_tol"],
                               atol=opts["linear_atol"],
                               restart=opts["gmresRestart"],
                               maxiter=opts["linearIter"], reverseGF=reverseGF,
                               precond=opts.get("preconditioner"), reduce=red)
            else:
                raise ValueError(
                    f"unknown linearSolver {solver!r}; available: minres, "
                    f"gmres (alias gcrotmk), exact (alias pardiso)")
            cls._account(opts, None, solver, res, 0)
            # the convergence scalars are host values already: the solver's
            # one read per iteration brought them back
            if not res.converged:
                msg = (f"Iterative solver {solver} did not converge: "
                       f"residual {res.resnorm:.3e} after "
                       f"{res.iterations} iterations")
                if opts.get("errorOnNonConvergence", True):
                    raise RuntimeError(msg)
                warnings.warn(msg)
            return b._like(res.x.reshape(b.array.shape))

    @classmethod
    def solveBatch(cls, H, bs, sigmas, x0s=None, opType: str = "her",
                   reverseGF: bool = False, rtol_scale: float = 1.0,
                   report=None):
        """Batched shifted solves of the (sigma_k, b_k) pairs, one lane
        each, as ONE lane-stack computation (block Lanczos batching):
        batched MINRES applies the operator once per iteration to all lanes.
        ``linearSystemArgs["batchChunk"]`` bounds the number of simultaneous
        lanes for memory; chunks run one after another.  A caller-passed
        ``report`` dict accumulates "iterations" (summed over lanes), as
        the ``linearSystemArgs["report"]`` dict does with "solves" and the
        applies ("matmats" for batched MINRES, "matvecs" for GMRES lanes).
        A lane that does not converge raises, or warns under
        ``errorOnNonConvergence=False``."""
        solver, opts = cls._solve_opts(bs[0], np.asarray(sigmas), opType)
        chunk = opts.get("batchChunk")
        if chunk and len(bs) > chunk:
            out = []
            for i in range(0, len(bs), chunk):
                out.extend(cls.solveBatch(
                    H, bs[i:i + chunk], sigmas[i:i + chunk],
                    x0s=None if x0s is None else x0s[i:i + chunk],
                    opType=opType, reverseGF=reverseGF,
                    rtol_scale=rtol_scale, report=report))
            return out
        with span("es.linear.solve"):
            op = cls._as_operator(H, bs[0])
            sig = np.asarray(sigmas)
            dtype = cls._solve_dtype(op, sig, *[b.dtype for b in bs])
            B = torch.stack([b.array.reshape(-1).to(dtype) for b in bs])
            if x0s is None:
                X0 = None
            elif isinstance(x0s, (list, tuple)):
                X0 = torch.stack([x.array.reshape(-1).to(dtype) for x in x0s])
            else:                       # raw (nlanes, n) warm-start stack
                X0 = as_tensor(x0s, B.device).to(dtype)

            if solver == "exact":
                outs = ls.solve_exact_batch(op, B, sig, reverseGF=reverseGF)
                res = ls.SolveResult(torch.stack([o.x for o in outs]),
                                     np.zeros(len(outs)),
                                     np.ones(len(outs), int),
                                     np.ones(len(outs), bool), 0)
            elif solver in ("minres", "gmres"):
                fn = ls.minres_batch if solver == "minres" else ls.gmres_batch
                kwargs = dict(rtol=opts["linear_tol"] * rtol_scale,
                              atol=opts["linear_atol"] * rtol_scale,
                              maxiter=opts["linearIter"], reverseGF=reverseGF,
                              precond=opts.get("preconditioner"))
                if solver == "gmres":
                    kwargs["restart"] = opts["gmresRestart"]
                nl = len(bs)
                B, sig, X0 = cls._pad_lanes(B, sig, X0, bs[0])
                res = _first_lanes(cls._batched(
                    lambda o, Bl, s, X0l, red: fn(o, Bl, s, x0s=X0l,
                                                 reduce=red, **kwargs),
                    op, B, sig, X0, bs[0]), nl)
            else:
                raise ValueError(
                    f"unknown linearSolver {solver!r}; available: minres, "
                    f"gmres (alias gcrotmk), exact (alias pardiso)")
            cls._account(opts, report, solver, res, len(bs))
            for k, ok in enumerate(res.converged):
                if not ok:
                    msg = (f"Batched solver {solver} lane {k} did not "
                           f"converge: residual "
                           f"{float(res.resnorm[k]):.3e} after "
                           f"{int(res.iterations[k])} iterations")
                    if opts.get("errorOnNonConvergence", True):
                        raise RuntimeError(msg)
                    warnings.warn(msg)
            return [bs[k]._like(x.reshape(bs[k].array.shape))
                    for k, x in enumerate(res.x)]


def _first_lanes(res, nl: int):
    """A batched solve's result without its padding lanes."""
    if res.x.shape[0] == nl:
        return res
    return res._replace(x=res.x[:nl], resnorm=res.resnorm[:nl],
                        iterations=res.iterations[:nl],
                        converged=res.converged[:nl])
