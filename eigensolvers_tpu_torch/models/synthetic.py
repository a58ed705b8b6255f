"""Synthetic known-spectrum problems — the test/bench oracle family.

Strategy parity: the reference's unit tests all use H = Qᵀ Λ Q with chosen Λ
(cheap, exact, controllable degeneracy/clustering — SURVEY.md §4).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import scipy.linalg as sla


def known_spectrum_matrix(n: int, eigenvalues=None, seed: int = 10,
                          degenerate_at: Optional[int] = None,
                          degeneracy: int = 1, dtype=np.float64):
    """Dense Hermitian H = Qᵀ Λ Q with prescribed spectrum.

    :param eigenvalues: spectrum (default linspace(1, 2n, n))
    :param degenerate_at: if set, eigenvalues[i:i+degeneracy] are made equal
        (engineered degenerate cluster, reference test_lanczosBlock.py:17-19)
    :returns: (H, eigenvalues actually used)
    """
    ev = np.array(eigenvalues if eigenvalues is not None
                  else np.linspace(1, 2 * n, n), dtype=float)
    if degenerate_at is not None:
        ev[degenerate_at:degenerate_at + degeneracy] = ev[degenerate_at]
    rng = np.random.RandomState(seed)
    Q = sla.qr(rng.rand(n, n))[0]
    H = (Q.T @ np.diag(ev) @ Q).astype(dtype)
    return H, ev


def random_sop_terms(nDim: int, dims: Sequence[int], nSum: int, seed: int = 1212,
                     dtype=np.float64, include_identity_term: bool = True):
    """Random Hermitian sum-of-products terms (the reference's random SoP
    tree operator, unittests/test_lanczosTTNS.py:45-53): nSum terms, each a
    product of random symmetric per-mode matrices; optionally one identity
    term.

    :returns: list of (coeff, {mode: matrix}) for
        :meth:`SumOfProductOperator.from_terms`.
    """
    rng = np.random.RandomState(seed)
    terms = []
    nrand = nSum - 1 if include_identity_term else nSum
    for s in range(nrand):
        facs = {}
        for d in range(nDim):
            m = rng.rand(dims[d], dims[d]) - 0.5
            if np.issubdtype(np.dtype(dtype), np.complexfloating):
                m = m + 1j * (rng.rand(dims[d], dims[d]) - 0.5)
            facs[d] = ((m + m.conj().T) / 2).astype(dtype)
        terms.append((1.0, facs))
    if include_identity_term:
        terms.append((1.0, {}))
    return terms


def coupled_quartic_oscillator_2d(N: int = 21, coupling: float = 0.1):
    """2-D coupled quartic oscillator as SoP terms:
    H = Σ_d (-1/2 d²/dq_d² + q_d⁴/2) + c q_0² q_1²
    (the degenerate-pair workload of reference
    unittests/test_lanczosBlockTTNS.py).

    :returns: (terms, bases) with Hermite-DVR bases.
    """
    from .bases import Hermite
    bases = [Hermite(Hermite.getOptions(N=N)) for _ in range(2)]
    terms = []
    for d in range(2):
        terms.append((1.0, {d: bases[d].op_ke()}))
        terms.append((0.5, {d: bases[d].op_q(4)}))
    terms.append((coupling, {0: bases[0].op_q(2), 1: bases[1].op_q(2)}))
    return terms, bases
