"""Discrete-variable-representation (DVR) and discrete basis sets.

Replaces the reference's external in-house ``basis`` package (SURVEY.md §2.3;
used by unittests/test_stateFollowingHO.py:16-20 — ``SincInfInf`` with
``mat_dx2``/``xi`` — and the SoP/TTNS tests' ``SincAB``, plus ``Hermite`` and
``electronic`` bases).

Formulas: sinc DVRs from Colbert & Miller, J. Chem. Phys. 96, 1982 (1992)
(infinite-range appendix A.1 and particle-in-a-box A.2); harmonic-oscillator
DVR from Gauss-Hermite quadrature.

Every basis provides: ``N`` (size), ``xi`` (grid points), ``mat_dx2``
(second-derivative matrix d²/dx²), ``mat_dx1`` where meaningful, and
operator builders used by the MCTDH .op parser (``op_q``, ``op_ke`` etc.).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


class BasisBase:
    """Common surface for DVR bases."""

    N: int
    xi: np.ndarray

    @classmethod
    def getOptions(cls, **kwargs):
        """Options-dict constructor idiom (parity with the reference's
        ``basis.X.getOptions(...)`` call sites)."""
        return kwargs

    # -- operator matrices used by .op Hamiltonians -------------------------
    def op_identity(self):
        return np.eye(self.N)

    def op_q(self, power: int = 1):
        """Position operator q^power (diagonal in a DVR; truncated matrix
        power in an FBR)."""
        X = getattr(self, "_X_fbr", None)
        if X is not None:
            return np.linalg.matrix_power(X, power)
        return np.diag(self.xi.astype(float) ** power)

    def op_dx2(self):
        return self.mat_dx2

    def op_ke(self, mass: float = 1.0):
        """Kinetic energy -1/(2m) d²/dx² (MCTDH ``KE`` convention)."""
        return -self.mat_dx2 / (2.0 * mass)


class SincInfInf(BasisBase):
    """Sinc DVR on an equidistant grid over (-inf, inf)
    (Colbert-Miller appendix A.1).

    Second-derivative matrix:
      d2[i,i]   = -pi^2 / (3 dx^2)
      d2[i,j]   = -2 (-1)^(i-j) / ((i-j)^2 dx^2)
    """

    def __init__(self, options):
        N = options["N"]
        xRange = options.get("xRange", [-10.0, 10.0])
        self.N = N
        self.xi = np.linspace(xRange[0], xRange[1], N)
        dx = self.xi[1] - self.xi[0]
        i = np.arange(N)
        diff = i[:, None] - i[None, :]
        with np.errstate(divide="ignore", invalid="ignore"):
            off = -2.0 * ((-1.0) ** diff) / (diff.astype(float) ** 2 * dx * dx)
        d2 = np.where(diff == 0, -np.pi ** 2 / (3.0 * dx * dx), off)
        self.mat_dx2 = d2

        # first derivative (antisymmetric): d1[i,j] = (-1)^(i-j)/((i-j) dx)
        with np.errstate(divide="ignore", invalid="ignore"):
            off1 = ((-1.0) ** diff) / (diff.astype(float) * dx)
        self.mat_dx1 = np.where(diff == 0, 0.0, off1)


class SincAB(BasisBase):
    """Sinc DVR for a particle in a box [a, b] (Colbert-Miller appendix A.2).

    Grid x_i = a + i*dx, i = 1..N, dx = (b-a)/(N+1); wavefunctions vanish at
    the box boundaries.  Second-derivative matrix in the sin form:
      d2[i,j] (i≠j) = -(-1)^(i-j) (pi/dx)^2 / (N+1)^2
                       * [1/(2 sin²(pi(i-j)/(2(N+1)))) - 1/(2 sin²(pi(i+j)/(2(N+1))))]
      d2[i,i]       = -(pi/dx)^2 / (N+1)^2
                       * [(2(N+1)^2+1)/6 - 1/(2 sin²(pi i/(N+1)))]
    """

    def __init__(self, options):
        N = options["N"]
        a = options.get("a", 0.0)
        b = options.get("b", options.get("L", float(N + 1)) + a)
        self.N = N
        dx = (b - a) / (N + 1)
        i = np.arange(1, N + 1)
        self.xi = a + i * dx

        ii = i[:, None]
        jj = i[None, :]
        n1 = N + 1
        pref = (np.pi / dx) ** 2 / n1 ** 2
        with np.errstate(divide="ignore", invalid="ignore"):
            sm2 = np.sin(np.pi * (ii - jj) / (2.0 * n1)) ** 2
            sp2 = np.sin(np.pi * (ii + jj) / (2.0 * n1)) ** 2
            off = -((-1.0) ** (ii - jj)) * pref * (0.5 / sm2 - 0.5 / sp2)
        dgv = -pref * ((2.0 * n1 ** 2 + 1.0) / 6.0
                       - 0.5 / np.sin(np.pi * i / n1) ** 2)
        d2 = np.where(ii == jj, 0.0, np.nan_to_num(off))
        d2[np.arange(N), np.arange(N)] = dgv
        self.mat_dx2 = d2


class Hermite(BasisBase):
    """Harmonic-oscillator basis: DVR (Gauss-Hermite grid) or FBR
    (finite basis representation in the first N HO eigenfunctions).

    ``representation="dvr"`` (default): grid = eigenvalues of the truncated
    position operator; position operators are diagonal, ``mat_dx2`` from the
    exact pointwise identity φ_n'' = (a⁴x² - (2n+1)a²) φ_n with a = sqrt(mω).

    ``representation="fbr"``: operators as truncated matrices in the HO
    eigenbasis — q^k is the k-th power of the tridiagonal position matrix.
    This is the Avila-Carrington convention for polynomial force fields
    (JCP 134, 054126 (2011)) and is essential for them: a wide DVR grid
    samples the unphysical turnover region of a polynomial PES (cubic/
    quartic terms with negative coefficients go to -inf at large |q|) and
    variational solvers collapse into it, while the truncated-basis FBR
    matrices never see it.
    """

    def __init__(self, options):
        N = options["N"]
        x0 = options.get("x0", 0.0)
        freq = options.get("omega", options.get("freq", 1.0))
        mass = options.get("mass", 1.0)
        self.representation = options.get("representation", "dvr")
        self.N = N
        a = np.sqrt(mass * freq)  # inverse length scale

        n = np.arange(N - 1)
        X = np.zeros((N, N))
        X[n, n + 1] = X[n + 1, n] = np.sqrt((n + 1) / 2.0) / a
        evx, U = np.linalg.eigh(X)
        self.xi = evx + x0
        signs = np.sign(U[0, :])
        signs[signs == 0] = 1.0
        U = U * signs

        # exact <m|x²|n> in the HO basis (tridiagonal in steps of 2)
        ns = np.arange(N)
        X2 = np.diag((2.0 * ns + 1.0) / (2.0 * a * a))
        m2 = np.arange(N - 2)
        X2[m2, m2 + 2] = X2[m2 + 2, m2] = \
            np.sqrt((m2 + 1.0) * (m2 + 2.0)) / (2.0 * a * a)
        d2_fbr = (a ** 4) * X2 - (a ** 2) * np.diag(2.0 * ns + 1.0)
        self.mat_dx2 = U.T @ d2_fbr @ U

        # first derivative: φ_n' = a (sqrt(n/2) φ_{n-1} - sqrt((n+1)/2) φ_{n+1})
        D1 = np.zeros((N, N))
        D1[n, n + 1] = a * np.sqrt((n + 1) / 2.0)
        D1[n + 1, n] = -a * np.sqrt((n + 1) / 2.0)
        self.mat_dx1 = U.T @ D1 @ U

        if self.representation == "fbr":
            # keep the FBR matrices themselves (untransformed)
            self._X_fbr = X + x0 * np.eye(N)
            self.mat_dx2 = d2_fbr
            self.mat_dx1 = D1


class Electronic(BasisBase):
    """Discrete n-state electronic basis (no grid); operators are
    elementary matrices S_{i&j} (parity with MCTDH electronic mode)."""

    def __init__(self, options):
        if isinstance(options, int):
            options = {"N": options}
        self.N = options["N"]
        self.xi = np.arange(self.N)

    @property
    def mat_dx2(self):
        raise NotImplementedError("no derivatives for a discrete basis")

    def op_S(self, i: int, j: int, symmetric: bool = True):
        """|i><j| (+ |j><i| when symmetric and i != j), 1-indexed like MCTDH
        ``S1&1`` labels."""
        m = np.zeros((self.N, self.N))
        m[i - 1, j - 1] = 1.0
        if symmetric and i != j:
            m[j - 1, i - 1] = 1.0
        return m


def electronic(n: int) -> Electronic:
    """Parity helper: ``basis.electronic(n)`` in reference test/example code."""
    return Electronic({"N": n})


_BASIS_KINDS = {
    "SincInfInf": SincInfInf,
    "SincAB": SincAB,
    "Hermite": Hermite,
    "electronic": Electronic,
    "Electronic": Electronic,
}


def basisFactory(kind: str, options) -> BasisBase:
    """Build a basis by name (parity with the reference's ``basisFactory``)."""
    try:
        cls = _BASIS_KINDS[kind]
    except KeyError:
        raise ValueError(f"unknown basis kind {kind!r}; known: {sorted(_BASIS_KINDS)}")
    return cls(options)
