"""Eigensolver algorithms (backend-generic via the AbstractVector contract)."""
from .lanczos import inexactLanczosDiagonalization

__all__ = ["inexactLanczosDiagonalization"]
