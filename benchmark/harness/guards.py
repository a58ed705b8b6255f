"""What a run checks about its process: a card to run on, and that no
module of JAX or of the JAX package was loaded."""

import sys

# Compared whole, as top-level module names (the part before the first
# dot): ``eigensolvers_tpu_torch`` begins with ``eigensolvers_tpu`` and
# must pass.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "eigensolvers_tpu"})


class NoDevice(RuntimeError):
    """The cell asks for more cards than the process sees."""


def forbidden_modules(modules=None):
    """The forbidden top-level names among ``modules`` (default: the
    modules loaded in this process), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)


def require_cards(chips):
    """Raise :class:`NoDevice` unless CUDA sees ``chips`` cards."""
    import torch
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is False: the benchmark "
                       "runs on an NVIDIA GPU only")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} cards, "
                       f"torch.cuda.device_count() is "
                       f"{torch.cuda.device_count()}")
