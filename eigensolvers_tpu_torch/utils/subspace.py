"""Small dense subspace numerics shared by both eigensolvers.

These are host-side (numpy/LAPACK) operations on the m×m projected matrices —
the right place for them: m ≲ 100, and on a multi-host mesh they are solved
redundantly per host to avoid broadcasts (SURVEY.md §2.4 item 3).

Parity: reference util_funcs.py (Löwdin orthogonalization :233-247,:346-358;
projected diagonalization :360-385; basis transformation :208-231; residual
:249-289; pick functions :305-344; selection helpers :112-130, :292-303).
The reference's dead functions with missing imports (eigRegularized, getRes,
util_funcs.py:31-108) are intentionally dropped (SURVEY.md §7).
"""

from __future__ import annotations

import warnings
from typing import List, Sequence

import numpy as np
import scipy.linalg as sla

from ..vectors.abstract import LINDEP_DEFAULT_VALUE


# ----------------------------------------------------------------------------
# selection helpers
# ----------------------------------------------------------------------------
def select_within_range(in_arr, arr_min, arr_max):
    """Elements of ``in_arr`` inside [arr_min, arr_max]; returns
    (values, indices)."""
    arr = np.asarray(in_arr)
    idx = np.nonzero((arr >= arr_min) & (arr <= arr_max))[0]
    return arr[idx], list(idx)


def find_nearest(array, value):
    """(index, value) of the element of ``array`` nearest to ``value``."""
    arr = np.asarray(array)
    idx = int(np.abs(arr - value).argmin())
    return idx, arr[idx]


def nearest_degenerate(array, value, degen_tol=1e-6):
    """(index, value) of the nearest element, warning when the array contains
    (near-)degenerate pairs (reference: util_funcs.py:133-144)."""
    arr = np.asarray(array)
    diffs = np.abs(arr[:, None] - arr[None, :])
    np.fill_diagonal(diffs, np.inf)
    if np.any(diffs <= degen_tol):
        warnings.warn("Got degeneracy among candidate eigenvalues")
    idx = int(np.abs(arr - value).argmin())
    return idx, arr[idx]


def calculateTarget(eigenvalues, indx, tol=1e-14):
    """Shift target placed a quarter-gap away from eigenvalue ``indx``;
    asserts non-degeneracy (reference: util_funcs.py:292-303)."""
    ev = np.asarray(eigenvalues)
    ediff1 = ev[indx] - ev[indx - 1]
    ediff2 = ev[indx + 1] - ev[indx]
    assert min(ediff1, ediff2) > tol, "Got a degenerate eigenvalue"
    return ev[indx] + min(ediff1, ediff2) * 0.25


# ----------------------------------------------------------------------------
# Löwdin orthogonalization + projected diagonalization
# ----------------------------------------------------------------------------
def lowdinOrtho(oMat, tol=LINDEP_DEFAULT_VALUE):
    """Canonical (Löwdin) orthogonalization: eigendecompose the overlap, drop
    eigenvalues <= tol, return the S^{-1/2} transform restricted to the
    independent subspace.

    :returns: (idx boolean array, all_independent flag, transform matrix)
    """
    evq, uvq = sla.eigh(np.asarray(oMat))
    idx = evq > tol
    evq = evq[idx]
    uvq = uvq[:, idx]
    info = bool(np.all(idx))
    uvqTraf = uvq * evq ** (-0.5)
    return idx, info, uvqTraf


def lowdinOrthoMatrix(S, status):
    """Wrapper that records linear dependence in the status dict
    (reference: util_funcs.py:346-358)."""
    _, linIndep, uS = lowdinOrtho(S)
    status["lindep"] = not linIndep
    return status, uS


def diagonalizeHamiltonian(X, Hmat, printObj=None):
    """Diagonalize X^H H X (projected Hermitian eigenproblem); returns
    (eigenvalues, eigenvectors).  Optionally logs through a reporter."""
    if printObj is not None:
        printObj.writeFile("hamiltonian", Hmat, "beforeOrthogonalization")
    Hp = X.conj().T @ np.asarray(Hmat) @ X
    ev, uv = sla.eigh(Hp)
    if printObj is not None:
        printObj.writeFile("hamiltonian", Hp, "afterOrthogonalization")
        printObj.writeFile("eigenvalues", ev)
    return ev, uv


def basisTransformation(bases: Sequence, coeffs: np.ndarray) -> List:
    """Linear-combine ``bases`` with coefficient matrix ``coeffs``.

    1-D coeffs → a single combined vector; 2-D (m, k) → k combined vectors
    (reference: util_funcs.py:208-231).  May return references to inputs for
    the trivial identity combination.
    """
    typeClass = bases[0].__class__
    coeffs = np.asarray(coeffs)
    out = []
    if coeffs.ndim == 1:
        if len(coeffs) == 1 and coeffs[0] == 1.0:
            # Identity combination: return the vector itself (the reference
            # appends the whole *list* here, util_funcs.py:225 — a latent bug
            # we do not replicate).
            out.append(bases[0])
        else:
            out.append(typeClass.linearCombination(list(bases), coeffs))
    else:
        batch = getattr(typeClass, "linearCombinationBatch", None)
        if batch is not None:
            # dense/sharded backends: all k combinations in one MXU matmul
            return batch(list(bases), coeffs)
        for j in range(coeffs.shape[1]):
            out.append(typeClass.linearCombination(list(bases), coeffs[:, j]))
    return out


# ----------------------------------------------------------------------------
# convergence residual
# ----------------------------------------------------------------------------
def eigenvalueResidual(ev: np.ndarray, reference: np.ndarray,
                       eigenvalueRange=None) -> float:
    """Residual = sum|reference - ev| / sum|ev|; optionally restricted to
    reference values inside ``eigenvalueRange`` = [emin, emax]
    (reference: util_funcs.py:249-289)."""
    ev = np.asarray(ev)
    reference = np.asarray(reference)

    if eigenvalueRange is not None:
        assert len(eigenvalueRange) == 2, \
            "eigenvalueRange must be [emin, emax]"
        emin, emax = eigenvalueRange
        if emin > emax:
            warnings.warn("emin greater than emax; proceeding with swapped values")
            emin, emax = emax, emin
        idx = select_within_range(reference, emin, emax)[1]
        if len(idx) >= 1:
            reference = reference[idx]
            ev = ev[idx]
            assert len(reference) == len(ev), "Eigenvalue counts differ"

    absDiff = float(np.sum(np.abs(reference - ev)))
    sumEigenvalue = float(np.sum(np.abs(ev)))
    return absDiff / sumEigenvalue


# ----------------------------------------------------------------------------
# pick functions (state selection / following)
# ----------------------------------------------------------------------------
def get_pick_function_close_to_sigma(toCompare):
    """Pick eigenstates by |eigenvalue - sigma| (default targeting,
    reference: util_funcs.py:330-344)."""
    def pick(transformMat, vectors, eigenvalues):
        return np.argsort(np.abs(np.asarray(eigenvalues) - toCompare))
    return pick


def get_pick_function_maxOvlp(toCompare):
    """Pick eigenstates by overlap with a reference vector, computed in
    Krylov coefficients without forming the full Ritz vectors
    (reference: util_funcs.py:305-328)."""
    def pick(transformMat, vectors, eigenvalues):
        nKrylov = transformMat.shape[0]
        overlapKrylov = np.empty(nKrylov, dtype=np.asarray(transformMat).dtype)
        for i in range(nKrylov):
            overlapKrylov[i] = vectors[i].vdot(toCompare)
        overlap = np.abs(np.asarray(transformMat).conj().T @ overlapKrylov)
        return np.argsort(-overlap)
    return pick
