"""Operators, the shifted linear solver and the CUDA kernels' wrappers."""
from .operators import (AbstractOperator, DenseOperator, DiagonalOperator,
                        as_operator)
from .sparse import BSROperator
from . import linear_solvers

__all__ = ["AbstractOperator", "DenseOperator", "DiagonalOperator",
           "BSROperator", "as_operator", "linear_solvers"]
