"""Dense targeted eigensolve: the framework's hello-world driver.

Inexact Lanczos near sigma on a dense matrix of known spectrum (reference:
examples/driver_numpyVector.py, small and larger configs).
Run: python -m eigensolvers_tpu_torch.examples.driver_dense [--large]
     [--cpu] [--out DIR]
"""

from __future__ import annotations

import os
import sys

import numpy as np

from . import _common as C

SMALL = dict(n=100, spread=300, target=30, maxit=4, L=6, eConv=1e-8,
             iters=1000)
LARGE = dict(n=2500, spread=1400, target=1290, maxit=20, L=50, eConv=1e-10,
             iters=8000)


def run(large=False, device=None, out=None):
    """Returns {"nearest", "exact", "ev", "status", "wall"}."""
    from .. import TorchVector, find_nearest, inexactLanczosDiagonalization
    from ..models.synthetic import known_spectrum_matrix

    dev = C.resolve_device(device)
    out = C.out_dir(out)
    p = LARGE if large else SMALL
    n = p["n"]
    H, ev = known_spectrum_matrix(n, eigenvalues=np.linspace(1, p["spread"],
                                                             n), seed=10)
    options = {"linearSystemArgs": {
        "linearSolver": "minres", "linearIter": p["iters"],
        "linear_tol": 1e-4, "errorOnNonConvergence": False}}
    rng = np.random.RandomState(0)
    Y0 = TorchVector(rng.rand(n), options, device=dev)

    with C.Wall(dev) as w:
        lf, xf, status = inexactLanczosDiagonalization(
            H, Y0, p["target"], p["L"], p["maxit"], p["eConv"],
            writeOut=True,
            outFileName=os.path.join(out, "iterations_lanczos.out"),
            summaryFileName=os.path.join(out, "summary_lanczos.out"))
    got = float(find_nearest(lf, p["target"])[1])
    want = float(find_nearest(ev, p["target"])[1])
    print(f"{'Eigenvalue nearest to sigma':50} :: {got:.8f}")
    print(f"{'Actual eigenvalue nearest to sigma':50} :: {want:.8f}")
    print(f"{'Time taken (in sec)':50} :: {w.s:.2f}")
    print(f"{'Converged':50} :: {status['isConverged']}")
    return {"nearest": got, "exact": want, "ev": np.asarray(lf),
            "status": status, "wall": w.s}


def main(argv=None):
    ap = C.parser(__doc__, out=True)
    ap.add_argument("--large", action="store_true",
                    help="n=2500 config (reference 'largerDenserSpetra')")
    args = ap.parse_args(argv)
    run(args.large, device=C.device_arg(args), out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
