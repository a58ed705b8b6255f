"""Quadrature rules for the FEAST contour integration.

Parity: reference util_funcs.py:146-166 (legendre / hermite / trapezoidal,
``positiveHalf`` filter for Hermitian contours, PRB 79, 115112 (2009) eqs.
4, 10).  The reference's trapezoidal rule has an off-by-one in both points and
weights (reference: util_funcs.py:14-27; SURVEY.md §7 "bugs NOT to
replicate") — implemented correctly here; legendre remains the default
everywhere.
"""

from __future__ import annotations

import numpy as np


def trapezoidal(nc: int):
    """Composite trapezoidal points/weights on [-1, 1] (endpoints included)."""
    if nc == 1:
        return np.zeros(1), np.array([2.0])
    points = np.linspace(-1.0, 1.0, nc)
    dx = points[1] - points[0]
    weights = np.full(nc, dx)
    weights[0] = weights[-1] = dx / 2.0
    return points, weights


def quadraturePointsWeights(nc: int, quad: str, positiveHalf: bool = True):
    """Return ``nc`` points/weights for rule ``quad`` ∈ {legendre, hermite,
    trapezoidal}.  ``positiveHalf=True`` keeps only points > 0 — sufficient
    for Hermitian problems integrating over the half contour."""
    if quad == "legendre":
        gk, wk = np.polynomial.legendre.leggauss(nc)
    elif quad == "hermite":
        gk, wk = np.polynomial.hermite.hermgauss(nc)
    elif quad == "trapezoidal":
        gk, wk = trapezoidal(nc)
    else:
        raise ValueError(f"unknown quadrature {quad!r}")

    if positiveHalf:
        idx = gk > 0.0
        gk = gk[idx]
        wk = wk[idx]
    return gk, wk
