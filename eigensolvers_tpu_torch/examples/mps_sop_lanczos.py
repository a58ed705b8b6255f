"""Compressed (MPS) targeted eigensolve of a sum-of-products Hamiltonian:
the scalable path for product spaces too large to densify.

A 6-mode random SoP (dims 3, 2, 3, 3, 3, 5) at a test-scale cut, checked
against a dense oracle (the role of the reference's TTNS Lanczos examples).
Run: python -m eigensolvers_tpu_torch.examples.mps_sop_lanczos [--cpu]
     [--out DIR]
"""

from __future__ import annotations

import os
import sys

import numpy as np

from . import _common as C


def run(device=None, out=None):
    """Returns {"level", "exact", "rel_err", "ev", "status", "wall"}."""
    from .. import (MPSVector, SumOfProductOperator, calculateTarget,
                    find_nearest, inexactLanczosDiagonalization)
    from ..models.synthetic import random_sop_terms

    dev = C.resolve_device(device)
    out = C.out_dir(out)
    dims = [3, 2, 3, 3, 3, 5]
    op = SumOfProductOperator.from_terms(
        6, dims, random_sop_terms(6, dims, 3, seed=1212), device=dev)
    evE = np.linalg.eigvalsh(np.asarray(op.to_dense().cpu()))
    target = float(calculateTarget(evE, 8))

    options = {"compressArgs": {"maxD": 80, "eps": 1e-12},
               "linearSystemArgs": {"linearSolver": "minres",
                                    "linearIter": 800, "linear_tol": 1e-3,
                                    "maxD": 80, "eps": 1e-12}}
    guess = MPSVector.random(dims, maxD=60, options=options, seed=7,
                             device=dev)

    with C.Wall(dev) as w:
        ev, uv, status = inexactLanczosDiagonalization(
            op, guess, target, L=25, maxit=10, eConv=1e-7, writeOut=True,
            outFileName=os.path.join(out, "iterations_lanczos.out"),
            summaryFileName=os.path.join(out, "summary_lanczos.out"))

    got = float(np.real(find_nearest(ev, target)[1]))
    want = float(find_nearest(evE, target)[1])
    rel = abs(got - want) / abs(want)
    print(f"MPS result {got:.10f} vs dense oracle {want:.10f} "
          f"(rel err {rel:.1e})")
    print(f"Krylov bond dims: {status['KSmaxD']}")
    print(f"wall {w.s:.2f} s")
    return {"level": got, "exact": want, "rel_err": rel,
            "ev": np.asarray(ev), "status": status, "wall": w.s}


def main(argv=None):
    args = C.parser(__doc__, out=True).parse_args(argv)
    run(device=C.device_arg(args), out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
