"""TorchVector — the dense torch backend of the AbstractVector contract.

Role parity with the reference's dense backend (reference: numpyVector.py)
and with the JAX package's ``JaxVector``:

* subspace assembly (overlap / operator matrices) is formulated as (m, n)
  matrix products instead of m^2 host-looped dots
  (reference: numpyVector.py:180-203 loops vdots);
* shifted solves run the solvers of
  :mod:`eigensolvers_tpu_torch.ops.linear_solvers` on the vector's device
  (MINRES, GMRES or exact), with a batched lane-stack path
  (:meth:`TorchVector.solveBatch`) for block Lanczos.

All products run at true fp32/fp64 (TF32 refused, see
:func:`~eigensolvers_tpu_torch.ops.operators.require_true_fp32`): the
Rayleigh-Ritz and lindep thresholds cannot afford a TF32 floor.

The small m×m matrices are returned as host numpy arrays: the projected
eigenproblems are solved on the host (LAPACK), the right place for
~100×100 problems.
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


def _mm(a, b):
    require_true_fp32(a)
    return a @ b


def _mgs(x, Q):
    """Sequential (modified) Gram-Schmidt of x against the rows of Q.

    For real data the dots are non-conjugated — a deliberate reproduction of
    the reference quirk (reference: numpyVector.py:133-140), which is
    identical to standard GS there.  For complex data that quirk is wrong
    (it does not orthogonalize against the Hermitian inner product), so
    complex inputs use conjugated dots.

    Returns (x_orth, innerprod) with innerprod = <x, x> (Hermitian for
    complex, plain for real — both real-valued for the lindep test)."""
    complex_data = x.is_complex() or Q.is_complex()
    for q in Q:
        if complex_data:
            term1 = torch.vdot(q, x)
            term2 = torch.vdot(q, q).real
        else:
            term1 = torch.dot(x, q)
            term2 = torch.dot(q, q)
        denom = torch.where(torch.abs(term2) > 0, term2, 1.0)
        x = x - (term1 / denom) * q
    if complex_data:
        return x, torch.vdot(x, x).real
    return x, torch.dot(x, x)


class TorchVector(AbstractVector):
    """Dense state vector backed by a torch tensor (any tensor shape;
    treated as a flat vector by the inner products).  A numpy ``array`` is
    placed on ``device`` (default: the CPU); a tensor stays where it is
    unless ``device`` is given."""

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

    # -- scalar ops ---------------------------------------------------------
    def __mul__(self, other):
        return type(self)(self.array * other, self.options)

    def __rmul__(self, other):
        return type(self)(self.array * other, self.options)

    def __truediv__(self, other):
        return type(self)(self.array / other, self.options)

    def __imul__(self, other):
        self.array = self.array * other
        return self

    def __itruediv__(self, other):
        self.array = self.array / other
        return self

    def __len__(self) -> int:
        return int(self.array.numel())

    def normalize(self) -> "TorchVector":
        self.array = self.array / torch.linalg.vector_norm(self.array)
        return self

    def norm(self) -> float:
        return float(torch.linalg.vector_norm(self.array))

    def real(self) -> "TorchVector":
        return type(self)(torch.real(self.array), self.options)

    def conjugate(self) -> "TorchVector":
        return type(self)(torch.conj_physical(self.array), self.options)

    def vdot(self, other, conjugate: bool = True):
        dtype = torch.promote_types(self.dtype, other.dtype)
        a = self.array.reshape(-1).to(dtype)
        b = other.array.reshape(-1).to(dtype)
        val = torch.vdot(a, b) if conjugate else torch.dot(a, b)
        return complex(val) if val.is_complex() else float(val)

    def copy(self) -> "TorchVector":
        return type(self)(self.array.clone(), self.options)

    @classmethod
    def _as_operator(cls, H, ref: "TorchVector"):
        """Coerce H for application to ``ref``-shaped vectors; a numpy or
        scipy H is placed on ``ref``'s device."""
        return as_operator(H, device=ref.device)

    def applyOp(self, operator) -> "TorchVector":
        op = self._as_operator(operator, self)
        return type(self)(op.matvec(self.array), self.options)

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
    def _stack(vectors: List["TorchVector"]) -> torch.Tensor:
        dtype = functools.reduce(torch.promote_types,
                                 [v.dtype for v in vectors])
        return torch.stack([v.array.reshape(-1).to(dtype) for v in vectors])

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
        return cls(out.reshape(vectors[0].array.shape), vectors[0].options)

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
        return [cls(out[j].reshape(shape), vectors[0].options)
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
            Q, R = torch.linalg.qr(V.T, mode="reduced")
            d = torch.abs(torch.diagonal(R)).cpu().numpy()
            ok = d * d > lindep
            if ok.all():
                Qh = Q.T
                return [cls(Qh[j].reshape(shape), xs[keep[j]].options)
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
        arr, innerprod = _mgs(x.array.reshape(-1).to(dtype), Q.to(dtype))
        innerprod = float(innerprod)
        if innerprod > lindep:
            arr = arr / math.sqrt(innerprod)
            return cls(arr.reshape(x.array.shape), x.options)
        return None

    @classmethod
    def overlapMatrix(cls, vectors: List["TorchVector"]) -> np.ndarray:
        V = cls._stack(vectors)
        return _mm(V.conj(), V.T).cpu().numpy()

    @classmethod
    def matrixRepresentation(cls, operator,
                             vectors: List["TorchVector"]) -> np.ndarray:
        op = cls._as_operator(operator, vectors[0])
        V = cls._stack(vectors)
        AV = op.matmat(V.T)                                  # (n, m)
        return _mm(V.conj(), AV.to(V.dtype)).cpu().numpy()

    @classmethod
    def extendOverlapMatrix(cls, vectors: List["TorchVector"],
                            overlap: np.ndarray) -> np.ndarray:
        V = cls._stack(vectors)
        col = _mm(V.conj(), V[-1]).cpu().numpy()  # col_i = <v_i | v_new>
        overlap = np.append(overlap, col[None, :-1].conj(), axis=0)
        overlap = np.append(overlap, col[:, None], axis=1)
        return overlap

    @classmethod
    def extendMatrixRepresentation(cls, operator, vectors: List["TorchVector"],
                                   opMat: np.ndarray) -> np.ndarray:
        op = cls._as_operator(operator, vectors[0])
        V = cls._stack(vectors)
        Hket = op.matvec(V[-1]).to(V.dtype)
        col = _mm(V.conj(), Hket).cpu().numpy()   # <v_i | A v_new>
        opMat = np.append(opMat, col[None, :-1].conj(), axis=0)
        opMat = np.append(opMat, col[:, None], axis=1)
        return opMat

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
        solver, opts = cls._solve_opts(b, sigma, opType)
        op = cls._as_operator(H, b)
        if cls._want_split(op, b, sigma, opts):
            raise NotImplementedError(
                "complex-shifted solves of a real operator take the "
                "split-complex path, which is not ported yet (ROADMAP "
                "Queue A, 'FEAST'); set linearSystemArgs['splitComplex'] "
                "= False for complex GMRES")
        dtype = cls._solve_dtype(op, sigma, b.dtype)
        barr = b.array.reshape(-1).to(dtype)
        x0arr = None if x0 is None else x0.array.reshape(-1).to(dtype)
        if solver == "exact":
            res = ls.solve_exact(op, barr, sigma, reverseGF=reverseGF)
        elif solver == "minres":
            res = ls.minres(op, barr, sigma, x0=x0arr,
                            rtol=opts["linear_tol"], atol=opts["linear_atol"],
                            maxiter=opts["linearIter"], reverseGF=reverseGF,
                            precond=opts.get("preconditioner"))
        elif solver == "gmres":
            res = ls.gmres(op, barr, sigma, x0=x0arr,
                           rtol=opts["linear_tol"], atol=opts["linear_atol"],
                           restart=opts["gmresRestart"],
                           maxiter=opts["linearIter"], reverseGF=reverseGF,
                           precond=opts.get("preconditioner"))
        else:
            raise ValueError(
                f"unknown linearSolver {solver!r}; available: minres, gmres "
                f"(alias gcrotmk), exact (alias pardiso)")
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
        return cls(res.x.reshape(b.array.shape), b.options)

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
                                 np.zeros(len(outs)), np.ones(len(outs), int),
                                 np.ones(len(outs), bool), 0)
        elif solver in ("minres", "gmres"):
            fn = ls.minres_batch if solver == "minres" else ls.gmres_batch
            kwargs = dict(rtol=opts["linear_tol"] * rtol_scale,
                          atol=opts["linear_atol"] * rtol_scale,
                          maxiter=opts["linearIter"], reverseGF=reverseGF,
                          precond=opts.get("preconditioner"))
            if solver == "gmres":
                kwargs["restart"] = opts["gmresRestart"]
            res = fn(op, B, sig, x0s=X0, **kwargs)
        else:
            raise ValueError(
                f"unknown linearSolver {solver!r}; available: minres, gmres "
                f"(alias gcrotmk), exact (alias pardiso)")
        cls._account(opts, report, solver, res, len(bs))
        for k, ok in enumerate(res.converged):
            if not ok:
                msg = (f"Batched solver {solver} lane {k} did not converge: "
                       f"residual {float(res.resnorm[k]):.3e} after "
                       f"{int(res.iterations[k])} iterations")
                if opts.get("errorOnNonConvergence", True):
                    raise RuntimeError(msg)
                warnings.warn(msg)
        return [cls(x.reshape(bs[k].array.shape), bs[k].options)
                for k, x in enumerate(res.x)]
