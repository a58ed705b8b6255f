"""Eigensolver algorithms (backend-generic via the AbstractVector contract)."""
from .lanczos import inexactLanczosDiagonalization
from .feast import feastDiagonalization
from .chebyshev import chebyshevFilteredDiagonalization
from .slicing import spectrumSlicingDiagonalization

__all__ = ["inexactLanczosDiagonalization", "feastDiagonalization",
           "chebyshevFilteredDiagonalization",
           "spectrumSlicingDiagonalization"]
