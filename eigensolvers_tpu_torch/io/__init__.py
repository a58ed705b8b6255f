"""I/O runtime: native async checkpoint writer."""
from .fastwriter import AsyncWriter

__all__ = ["AsyncWriter"]
