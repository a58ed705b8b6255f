"""A solve through the entry point that a traffic mix names
(``entries/<entry>.py``), the pieces that entries share, and the port's
own counters around it."""

import numpy as np
import torch

from . import spec


def vectors(G, traffic, report):
    """The guesses as the port's vectors, with the mix's ``linear``
    options (and ``report``, where the solver counts its work)."""
    from eigensolvers_tpu_torch import TorchVector
    opts = {}
    if "linear" in traffic:
        opts["linearSystemArgs"] = dict(traffic["linear"], report=report)
    return [TorchVector(g, opts) for g in G]


def solve(op, G, tin, traffic, report):
    """(eigenvalues, the returned vectors as one (k, n) tensor, converged,
    the solver's status)."""
    ev, Y, status = spec.entry(traffic["entry"])(op, G, tin, traffic, report)
    V = torch.stack([y.array.reshape(-1) for y in Y])
    return np.asarray(ev), V, bool(status["isConverged"]), status


def merged(traffic, overrides):
    """``traffic`` with the dict-valued entries of ``overrides`` merged
    into its own (the warm-up's shorter solves)."""
    out = dict(traffic)
    for k, v in overrides.items():
        out[k] = dict(traffic.get(k, {}), **v) if isinstance(v, dict) else v
    return out


def _profiling():
    try:
        from eigensolvers_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling


def counts():
    """The port's counters now (``utils/profiling.py::snapshot``: span or
    counter name -> {"calls", "seconds"}); {} where the program has
    none."""
    p = _profiling()
    return p.snapshot() if p else {}


def counts_since(before):
    """What the port's counters gained since ``counts()`` gave
    ``before``: the names that gained a call."""
    p = _profiling()
    return p.delta(before) if p else {}
