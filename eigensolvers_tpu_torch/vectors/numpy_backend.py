"""NumpyVector — CPU numpy/scipy backend of the AbstractVector contract
(a copy of the JAX package's ``vectors/numpy_backend.py``).

Role parity with the reference's dense backend (reference: numpyVector.py):
a plain host implementation used for (a) environments without an
accelerator, (b) cross-checking the torch backends, and (c) the
"reference-native stack" (numpy + compiled SciPy Krylov solvers) that
device runs are compared against.  It runs on the host by definition: no
torch, no device.

Structured like
:class:`~eigensolvers_tpu_torch.vectors.dense.TorchVector` (stacked-basis
matmul formulations, classmethod collectives) rather than like the
reference's per-pair loops.
"""

from __future__ import annotations

import warnings
from typing import List, Optional

import numpy as np
import scipy.sparse.linalg as spla

from .abstract import AbstractVector, LINDEP_DEFAULT_VALUE
from ..config import normalize_options


class NumpyVector(AbstractVector):
    """Dense CPU state vector (numpy array of any tensor shape)."""

    def __init__(self, array, options: Optional[dict] = None):
        self.array = np.asarray(array)
        options = normalize_options(options)
        opt = dict(options.get("linearSystemArgs", {}))
        opt.setdefault("linearSolver", "minres")
        opt.setdefault("linearIter", 1000)
        opt.setdefault("linear_tol", 1e-4)
        opt.setdefault("linear_atol", 1e-4)
        opt.setdefault("errorOnNonConvergence", True)
        options["linearSystemArgs"] = opt
        self.options = options

    # -- properties ---------------------------------------------------------
    @property
    def hasExactAddition(self) -> bool:
        return True

    @property
    def dtype(self):
        return self.array.dtype

    @property
    def maxD(self) -> int:
        return 0

    # -- scalar ops ---------------------------------------------------------
    def __mul__(self, other):
        return type(self)(self.array * other, self.options)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return type(self)(self.array / other, self.options)

    def __imul__(self, other):
        self.array = self.array * other
        return self

    def __itruediv__(self, other):
        self.array = self.array / other
        return self

    def __len__(self) -> int:
        return int(self.array.size)

    def normalize(self):
        self.array = self.array / np.linalg.norm(self.array.ravel())
        return self

    def norm(self) -> float:
        return float(np.linalg.norm(self.array.ravel()))

    def real(self):
        return type(self)(np.real(self.array), self.options)

    def conjugate(self):
        return type(self)(np.conj(self.array), self.options)

    def vdot(self, other, conjugate: bool = True):
        if conjugate:
            return np.vdot(self.array.ravel(), other.array.ravel())
        return np.dot(self.array.ravel(), other.array.ravel())

    def copy(self):
        return type(self)(self.array.copy(), self.options)

    def applyOp(self, operator):
        mv = getattr(operator, "matvec", None)
        out = mv(self.array) if mv is not None else operator @ self.array.ravel()
        return type(self)(np.asarray(out).reshape(self.array.shape), self.options)

    def compress(self):
        return self

    def to_state_dict(self) -> dict:
        return {"kind": np.asarray("numpy"), "array": self.array}

    @classmethod
    def from_state_dict(cls, state: dict, options=None):
        return cls(state["array"], options)

    # -- collective ops (stacked formulations) ------------------------------
    @classmethod
    def _stack(cls, vectors: List["NumpyVector"]):
        return np.stack([v.array.ravel() for v in vectors])

    @classmethod
    def linearCombination(cls, vectors, coeffs):
        V = cls._stack(vectors)
        c = np.asarray(coeffs, dtype=np.result_type(V.dtype, np.asarray(coeffs).dtype))
        out = c @ V.astype(c.dtype)
        return cls(out.reshape(vectors[0].array.shape), vectors[0].options)

    @classmethod
    def orthogonalize(cls, xs, lindep=LINDEP_DEFAULT_VALUE):
        """Whole-set orthonormalization via host QR, dropping dependent
        directions (reference: util_funcs.py:170-194 `_qr`)."""
        keep = list(range(len(xs)))
        shape = xs[0].array.shape
        for _ in range(len(xs)):
            V = cls._stack([xs[i] for i in keep])
            Q, R = np.linalg.qr(V.T)
            d = np.abs(np.diagonal(R))
            ok = d * d > lindep
            if ok.all():
                return [cls(Q.T[j].reshape(shape), xs[keep[j]].options)
                        for j in range(len(keep))]
            keep = [keep[j] for j in range(len(keep)) if ok[j]]
            if not keep:
                return []
        return []  # pragma: no cover

    @classmethod
    def orthogonalize_against_set(cls, x, qs, lindep=LINDEP_DEFAULT_VALUE):
        """Sequential MGS with non-conjugated dots (matching the dense JAX
        backend / reference quirk)."""
        arr = x.array.ravel().copy()
        for q in qs:
            qa = q.array.ravel()
            term1 = np.dot(arr, qa)
            term2 = np.dot(qa, qa)
            arr -= (term1 / term2) * qa
        innerprod = np.dot(arr, arr)
        if np.real(innerprod) > lindep:
            arr = arr / np.sqrt(innerprod)
            return cls(arr.reshape(x.array.shape), x.options)
        return None

    @classmethod
    def overlapMatrix(cls, vectors):
        V = cls._stack(vectors)
        return V.conj() @ V.T

    @classmethod
    def matrixRepresentation(cls, operator, vectors):
        V = cls._stack(vectors)
        AV = np.stack([vectors[0].__class__(v.reshape(vectors[0].array.shape),
                                            vectors[0].options)
                       .applyOp(operator).array.ravel() for v in V])
        return V.conj() @ AV.T

    @classmethod
    def extendOverlapMatrix(cls, vectors, overlap):
        V = cls._stack(vectors)
        col = V.conj() @ V[-1]
        overlap = np.append(overlap, col[None, :-1].conj(), axis=0)
        overlap = np.append(overlap, col[:, None], axis=1)
        return overlap

    @classmethod
    def extendMatrixRepresentation(cls, operator, vectors, opMat):
        V = cls._stack(vectors)
        ket = vectors[-1].applyOp(operator).array.ravel()
        col = V.conj() @ ket
        opMat = np.append(opMat, col[None, :-1].conj(), axis=0)
        opMat = np.append(opMat, col[:, None], axis=1)
        return opMat

    # -- linear solves (compiled SciPy Krylov — the reference-native path) ---
    @classmethod
    def solve(cls, H, b, sigma, x0=None, opType="her", reverseGF=False):
        mv = getattr(H, "matvec", None) or (lambda x: H @ x)
        n = b.array.size
        dtype = np.result_type(np.asarray(sigma).dtype, b.dtype)
        sign = -1.0 if reverseGF else 1.0

        linOp = spla.LinearOperator(
            (n, n), matvec=lambda x: sign * (sigma * x - np.asarray(mv(x)).ravel()),
            dtype=dtype)
        opts = b.options["linearSystemArgs"]
        solver = {"gcrotmk": "gcrotmk", "gmres": "gcrotmk",
                  "pardiso": "exact", "exact": "exact"}.get(
                      opts["linearSolver"], opts["linearSolver"])
        rhs = b.array.ravel().astype(dtype)
        if solver == "exact":
            A = sign * (sigma * np.eye(n, dtype=dtype) - np.asarray(H, dtype=dtype))
            wk = np.linalg.solve(A, rhs)
            conv = 0
        elif solver == "minres" and not np.iscomplexobj(np.zeros((), dtype)):
            wk, conv = spla.minres(linOp, rhs,
                                   x0=None if x0 is None else x0.array.ravel(),
                                   rtol=opts["linear_tol"],
                                   maxiter=opts["linearIter"])
        else:
            wk, conv = spla.gcrotmk(linOp, rhs,
                                    x0=None if x0 is None else x0.array.ravel(),
                                    rtol=opts["linear_tol"],
                                    atol=opts["linear_atol"],
                                    maxiter=opts["linearIter"])
        if conv != 0:
            msg = f"SciPy solver {solver} did not converge (info={conv})"
            if opts.get("errorOnNonConvergence", True):
                raise RuntimeError(msg)
            warnings.warn(msg)
        return cls(wk.reshape(b.array.shape), b.options)
