"""Unit conversion for energies (atomic units ↔ spectroscopy units).

Replaces the reference's external in-house ``util.au2unit``/``util.unit2au``
(SURVEY.md §2.3; used at reference printUtils.py:9-18 and in the CH3CN
examples).  Conversion factors: 2018 CODATA.
"""

from __future__ import annotations

import numpy as np

# 1 hartree in <unit>
_AU_TO = {
    "au": 1.0,
    "hartree": 1.0,
    "cm-1": 219474.6313632,     # wavenumbers
    "cm1": 219474.6313632,
    "ev": 27.211386245988,
    "mev": 27211.386245988,
    "kcal/mol": 627.5094740631,
    "kj/mol": 2625.4996394799,
    "k": 315775.02480407,       # kelvin
    "hz": 6.579683920502e15,
    "thz": 6.579683920502e3,
    "nm": 45.56335252912,       # wavelength equivalent: au2unit gives nm*E? see below
}


def au2unit(value, unit: str = "au"):
    """Convert energy from hartree to ``unit``."""
    unit = unit.lower()
    if unit == "nm":
        # wavelength is inverse energy
        return _AU_TO["nm"] / np.asarray(value)
    try:
        return np.asarray(value) * _AU_TO[unit]
    except KeyError:
        raise ValueError(f"unknown unit {unit!r}; known: {sorted(_AU_TO)}")


def unit2au(value, unit: str = "au"):
    """Convert energy from ``unit`` to hartree."""
    unit = unit.lower()
    if unit == "nm":
        return _AU_TO["nm"] / np.asarray(value)
    try:
        return np.asarray(value) / _AU_TO[unit]
    except KeyError:
        raise ValueError(f"unknown unit {unit!r}; known: {sorted(_AU_TO)}")
