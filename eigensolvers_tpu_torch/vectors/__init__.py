"""Vector backends implementing the AbstractVector contract."""
from .abstract import AbstractVector, LINDEP_DEFAULT_VALUE
from .dense import TorchVector

__all__ = ["AbstractVector", "LINDEP_DEFAULT_VALUE", "TorchVector"]
