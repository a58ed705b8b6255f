"""ch3cn6: the inputs and traffic hooks of the CH3CN sum-of-products cut
(sizes in ``ch3cn6.json``).  The input is the configuration's own copy of
the ``.op`` file, handed to the port (``ch3cn6_program.py``) and to the
reference (``ch3cn6_ref.py``) alike; this module reads it with the
reference's parser for sigma and for the bound of one apply."""

from pathlib import Path

import torch

from ..harness.peaks import ITEMSIZE, bound_s
from .ch3cn6_ref import AU_TO, cut_terms

ROOT = Path(__file__).resolve().parents[2]


class Inputs:
    def __init__(self, sizes):
        self.sizes = sizes
        self.op_file = ROOT / sizes["op_file"]
        k, N = sizes["nModes"], sizes["N"]
        self.dims = (N,) * k
        self.n = N ** k
        self.dtype = getattr(torch, sizes["dtype"])
        params, self.terms = cut_terms(self.op_file, k)
        # the harmonic zero-point energy of the kept modes
        self.zpve = 0.5 * sum(params[f"w{i + 1}"] for i in range(k))


def inputs(sizes):
    return Inputs(sizes)


def traffic_inputs(inp, traffic):
    """``sigma``: {"below_zpve_cm": c} puts sigma c cm-1 below the kept
    modes' harmonic zero-point energy (below the bottom of H)."""
    return {"sigma": inp.zpve - traffic["sigma"]["below_zpve_cm"]
            / AU_TO["cm-1"]}


def guesses(inp, traffic, gen, device):
    """One product state per entry of ``guess.excited`` (the listed modes,
    0-based, carry one quantum; the others none) plus ``guess.noise``
    times normal noise from ``gen``, orthonormal, in f64 on ``device``."""
    g = traffic["guess"]
    G = g["noise"] * torch.randn((len(g["excited"]), inp.n), generator=gen,
                                 dtype=torch.float64, device=device)
    k, N = inp.sizes["nModes"], inp.sizes["N"]
    for row, excited in enumerate(g["excited"]):
        # the product basis is row-major over the modes
        G[row, sum(N ** (k - 1 - d) for d in excited)] += 1.0
    return torch.linalg.qr(G.T)[0].T.contiguous()


def apply_flops(inp):
    """The useful flops of one apply to one vector: the physical modes'
    grouped product (terms grouped by the modes they touch; S_g terms in a
    group cost 2 S_g N n per active mode; a one-mode group sums to one
    matrix, S_g = 1), plus 2 n for the identity terms, whatever form (fused
    or not) the program runs."""
    groups = {}
    for _, facs in inp.terms:
        if facs:
            key = tuple(sorted(facs))
            groups[key] = groups.get(key, 0) + 1
    N, n = inp.sizes["N"], inp.n
    return 2 * n + sum(2 * (1 if len(m) == 1 else S) * N * n * len(m)
                       for m, S in groups.items())


def apply_bound_s(inp, lanes, kind):
    """The least time of one apply to ``lanes`` vectors in type ``kind``:
    each x lane read once and each y lane written once against the useful
    flops (``apply_flops``) at the type's peak."""
    nbytes = lanes * inp.n * ITEMSIZE[kind]
    return bound_s(nbytes, nbytes, lanes * apply_flops(inp), kind)


def reference(inp, device):
    """The plain reference, given the same .op file and cut."""
    from .ch3cn6_ref import Reference
    return Reference(inp.op_file, inp.sizes["nModes"], inp.sizes["N"],
                     device)
