"""The backend contract: every solver in this framework is written ONLY
against this interface.

This mirrors the reference contract (reference: abstractVector.py:15-169) so a
user of the reference library can switch backends/frameworks without touching
solver code.  Concrete backend in this package:
:class:`~eigensolvers_tpu_torch.vectors.dense.TorchVector` — a dense torch
tensor on one device (CPU or CUDA), with the torch Krylov solvers.

Dispatch convention: the algorithms never import a concrete backend; they take
``typeClass = type(v0[0])`` and call the static methods
(reference: inexact_Lanczos.py:284, feast.py:168).  That is the seam where new
backends plug in.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Optional, Sequence

import numpy as np

# Threshold below which a squared norm counts as linearly dependent
# (reference: abstractVector.py:12).  Requires float64.
LINDEP_DEFAULT_VALUE = 1e-14


class AbstractVector(ABC):
    """A state vector living in some (possibly huge / compressed) space."""

    # ------------------------------------------------------------------
    # properties
    # ------------------------------------------------------------------
    @property
    @abstractmethod
    def hasExactAddition(self) -> bool:
        """True if linear combinations are exact (arrays), False if they are
        approximated by a fit (tensor-network states).  FEAST chooses between
        the 1-solve and 2-solve quadrature formulas based on this flag
        (reference: abstractVector.py:17-26, feast.py:89-101)."""
        raise NotImplementedError

    @property
    @abstractmethod
    def dtype(self):
        raise NotImplementedError

    @property
    @abstractmethod
    def maxD(self) -> int:
        """Maximum virtual bond dimension (0 for uncompressed backends);
        telemetry for the KSmaxD/fitmaxD channels
        (reference: abstractVector.py:33-37)."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    # elementwise / scalar ops
    # ------------------------------------------------------------------
    @abstractmethod
    def __mul__(self, other):
        raise NotImplementedError

    @abstractmethod
    def __rmul__(self, other):
        raise NotImplementedError

    @abstractmethod
    def __truediv__(self, other):
        raise NotImplementedError

    @abstractmethod
    def __imul__(self, other):
        raise NotImplementedError

    @abstractmethod
    def __itruediv__(self, other):
        raise NotImplementedError

    @abstractmethod
    def __len__(self) -> int:
        raise NotImplementedError

    @abstractmethod
    def normalize(self) -> "AbstractVector":
        """Normalize in place; returns self."""
        raise NotImplementedError

    @abstractmethod
    def norm(self) -> float:
        raise NotImplementedError

    @abstractmethod
    def real(self) -> "AbstractVector":
        raise NotImplementedError

    @abstractmethod
    def conjugate(self) -> "AbstractVector":
        raise NotImplementedError

    @abstractmethod
    def vdot(self, other, conjugate: bool = True):
        """<self|other> (bra conjugated) or plain dot when ``conjugate=False``."""
        raise NotImplementedError

    @abstractmethod
    def copy(self) -> "AbstractVector":
        raise NotImplementedError

    @abstractmethod
    def applyOp(self, operator) -> "AbstractVector":
        """Return operator @ self."""
        raise NotImplementedError

    @abstractmethod
    def compress(self) -> "AbstractVector":
        """Compress if compressible; may return self or a copy."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    # collective / static ops (the typeClass dispatch surface)
    # ------------------------------------------------------------------
    @staticmethod
    def linearCombination(vectors: Sequence["AbstractVector"], coeffs):
        """Return sum_i coeffs[i] * vectors[i] (may be a variational fit for
        compressed backends)."""
        raise NotImplementedError

    @staticmethod
    def orthogonalize(xs, lindep=LINDEP_DEFAULT_VALUE):
        """Orthonormalize the whole set; directions whose residual against
        the preceding kept vectors has squared norm <= ``lindep`` are
        dropped (reference: abstractVector.py:112, ttnsVector.py:151,
        util_funcs.py:170-194 `_qr`).  Returns the kept orthonormal list."""
        raise NotImplementedError

    @staticmethod
    def orthogonalize_against_set(x, xs, lindep=LINDEP_DEFAULT_VALUE):
        """Orthogonalize ``x`` against the orthonormal set ``xs``; return the
        normalized result, or None on linear dependence (squared norm below
        ``lindep``, reference: numpyVector.py:121-145)."""
        raise NotImplementedError

    @staticmethod
    def solve(H, b, sigma, x0=None, opType: str = "her", reverseGF: bool = False):
        """Approximately solve the shifted linear system (sigma*I - H) x = b.

        :param opType: "gen" generic, "sym" complex-symmetric, "her" hermitian,
            "pos" positive definite (reference: abstractVector.py:127-139).
        :param reverseGF: False → Green's function (sigma - H);
            True → reverse Green's function (H - sigma).
        """
        raise NotImplementedError

    @classmethod
    def solveBatch(cls, H, bs: List["AbstractVector"], sigmas, x0s=None,
                   opType: str = "her", reverseGF: bool = False,
                   rtol_scale: float = 1.0, report=None):
        """Solve a batch of shifted systems (sigmas[k]*I - H) x_k = bs[k].

        Batched extension of the contract: FEAST's quadrature×subspace loop
        (reference: feast.py:189-200) and block-Lanczos' block loop
        (reference: inexact_Lanczos.py:319-325) are embarrassingly parallel
        across shifts/right-hand sides; batched backends override this with a
        vmapped solver.  The default falls back to a sequential loop so every
        backend supports it.

        ``rtol_scale`` tightens the configured ``linear_tol`` for this call
        only (FEAST's warm-started inexact schedule); the fallback applies it
        by a scoped override of the shared ``linearSystemArgs`` dict (options
        are intentionally shared by reference — reference ttnsVector.py:114-117
        — so the override is restored before returning).  ``report`` is the
        batched backends' iteration-count accumulator; the sequential fallback
        cannot see inside the backend's solver and leaves it untouched.
        """
        if x0s is None:
            x0s = [None] * len(bs)
        guesses = []
        for b, x0 in zip(bs, x0s):
            if x0 is not None and not isinstance(x0, AbstractVector):
                # raw warm-start stack row (FEAST Ritz guesses): wrap it in
                # the backend type if the backend is array-like
                arr = getattr(b, "array", None)
                x0 = cls(np.asarray(x0).reshape(arr.shape), b.options) \
                    if arr is not None else None
            guesses.append(x0)
        lsa = bs[0].options.get("linearSystemArgs")
        scaled = (rtol_scale != 1.0 and lsa is not None
                  and "linear_tol" in lsa)
        if scaled:
            saved = lsa["linear_tol"]
            lsa["linear_tol"] = saved * rtol_scale
        try:
            return [cls.solve(H, b, s, x0=x0, opType=opType,
                              reverseGF=reverseGF)
                    for b, s, x0 in zip(bs, sigmas, guesses)]
        finally:
            if scaled:
                lsa["linear_tol"] = saved

    @staticmethod
    def matrixRepresentation(operator, vectors):
        """m×m matrix <v_i| operator |v_j> of a *Hermitian* operator."""
        raise NotImplementedError

    @staticmethod
    def overlapMatrix(vectors):
        """m×m overlap matrix <v_i|v_j>."""
        raise NotImplementedError

    @staticmethod
    def extendMatrixRepresentation(operator, vectors, opMat):
        """Extend ``opMat`` by one row/column for the newly appended vector
        (last element of ``vectors``); O(m) instead of O(m^2) rebuild
        (reference: numpyVector.py:205-221)."""
        raise NotImplementedError

    @staticmethod
    def extendOverlapMatrix(vectors, overlap):
        """Extend the overlap matrix by one row/column for the newly appended
        vector (reference: numpyVector.py:223-238)."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    # checkpointing (backend-neutral; the reference's TTNS-only HDF5 dump
    # crashed the dense backend — see SURVEY.md §5 / §7)
    # ------------------------------------------------------------------
    def to_state_dict(self) -> dict:
        """Serialize to a flat dict of numpy arrays (for checkpointing)."""
        raise NotImplementedError

    @classmethod
    def from_state_dict(cls, state: dict, options: Optional[dict] = None):
        """Reconstruct a vector from :meth:`to_state_dict` output."""
        raise NotImplementedError
