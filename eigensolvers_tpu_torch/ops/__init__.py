"""Operators, the shifted linear solver and the CUDA kernels' wrappers."""
from .operators import (AbstractOperator, CallableOperator, DenseOperator,
                        DiagonalOperator, GroupedSoPOperator,
                        SumOfProductOperator, as_operator)
from .sparse import BandedOperator, BSROperator
from . import linear_solvers

__all__ = ["AbstractOperator", "CallableOperator", "DenseOperator",
           "DiagonalOperator", "GroupedSoPOperator", "SumOfProductOperator",
           "BSROperator", "BandedOperator",
           "as_operator", "linear_solvers"]
