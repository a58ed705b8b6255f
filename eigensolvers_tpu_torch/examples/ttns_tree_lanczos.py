"""Targeted eigensolve with TREE tensor-network states over a branched
topology: the tree counterpart of ``mps_sop_lanczos``.

The same 6-mode random SoP on a root with two branches (the second a
3-node chain), against a dense oracle: first with compressed-Krylov
solves, then with the tree-ALS sweep engine seeded from a tree-DMRG guess
(the reference's production solver class on trees, ttnsVector.py:169-196).
Run: python -m eigensolvers_tpu_torch.examples.ttns_tree_lanczos [--cpu]
     [--out DIR]
"""

from __future__ import annotations

import os
import sys

import numpy as np

from . import _common as C


def run(device=None, out=None):
    """Returns {"sigma", "exact", "krylov", "als", "dmrg", "status",
    "status_als", "wall"}; raises if either solve misses the oracle by
    1e-5 relative."""
    from .. import (SumOfProductOperator, TTNSVector, calculateTarget,
                    find_nearest, inexactLanczosDiagonalization, parseTree)
    from ..models.synthetic import random_sop_terms
    from ..vectors.ttns import TTNO
    from ..vectors.ttns_sweeps import tree_dmrg_eigensolve

    dev = C.resolve_device(device)
    out = C.out_dir(out)
    # root with two branches; the second branch is itself a 3-node chain
    topo = parseTree([[], [[], [[]]]])
    dims = [3, 2, 3, 3, 3, 5]
    op = SumOfProductOperator.from_terms(
        6, dims, random_sop_terms(6, dims, 3, seed=1212), device=dev)
    H = np.asarray(op.to_dense().cpu())
    ev = np.linalg.eigvalsh(H)
    sigma = float(calculateTarget(ev, 8))

    options = {
        "compressArgs": {"maxD": 60, "eps": 1e-10},
        "linearSystemArgs": {"linearSolver": "minres", "linearIter": 300,
                             "linear_tol": 1e-5, "maxD": 60, "eps": 1e-10},
    }
    with C.Wall(dev) as w:
        Y0 = TTNSVector.random(topo, dims, 8, options, seed=11, device=dev)
        evL, uv, status = inexactLanczosDiagonalization(
            op, Y0, sigma, 10, 6, 1e-8, writeOut=True,
            outFileName=os.path.join(out, "iterations_lanczos.out"),
            summaryFileName=os.path.join(out, "summary_lanczos.out"))
        got = float(np.real(find_nearest(evL, sigma)[1]))
        want = float(find_nearest(ev, sigma)[1])
        print(f"target sigma      : {sigma:.8f}")
        print(f"tree Lanczos      : {got:.10f}")
        print(f"dense eigh oracle : {want:.10f}")
        print(f"rel. error        : {abs(got - want) / abs(want):.2e}")
        print(f"converged={status['isConverged']}  "
              f"KSmaxD={status['KSmaxD']}")
        if not (status["isConverged"] and abs(got - want) / abs(want) < 1e-5):
            raise RuntimeError("tree Lanczos missed the dense oracle")

        # same solve through the tree-ALS sweep engine, DMRG-seeded guess
        als_opts = {
            "compressArgs": {"maxD": 60, "eps": 1e-10},
            "linearSystemArgs": {"method": "als", "nSweep": 12,
                                 "convTol": 1e-7, "siteTol": 1e-9,
                                 "linearIter": 200, "linear_tol": 1e-5,
                                 "maxD": 60, "eps": 1e-10},
        }
        es, xs = tree_dmrg_eigensolve(topo, TTNO.from_sop(topo, op).tensors,
                                      dims, nStates=1, maxD=16, nSweep=8)
        print(f"tree-DMRG ground  : {es[0]:.10f} (oracle {ev[0]:.10f})")
        Y0a = TTNSVector(xs[0], als_opts, topo=topo)
        evA, _, stA = inexactLanczosDiagonalization(
            op, Y0a, sigma, 10, 6, 1e-8, writeOut=False)
        gotA = float(np.real(find_nearest(evA, sigma)[1]))
        print(f"tree-ALS Lanczos  : {gotA:.10f}  rel. error "
              f"{abs(gotA - want) / abs(want):.2e}  "
              f"converged={stA['isConverged']}")
        if abs(gotA - want) / abs(want) >= 1e-5:
            raise RuntimeError("tree-ALS Lanczos missed the dense oracle")
    print(f"wall {w.s:.2f} s")
    return {"sigma": sigma, "exact": want, "krylov": got, "als": gotA,
            "dmrg": float(es[0]), "oracle_ground": float(ev[0]),
            "status": status, "status_als": stA, "wall": w.s}


def main(argv=None):
    args = C.parser(__doc__, out=True).parse_args(argv)
    run(device=C.device_arg(args), out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
