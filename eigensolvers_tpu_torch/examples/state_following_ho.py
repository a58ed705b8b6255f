"""State following on the sinc-DVR harmonic oscillator: follow one
eigenstate by overlap instead of energy distance.

The second-nearest level to sigma = 13.1 (past the nearer root), picked by
maximum overlap with its exact eigenvector (reference:
examples/stateFollowingHO.py).
Run: python -m eigensolvers_tpu_torch.examples.state_following_ho [--cpu]
     [--out DIR]
"""

from __future__ import annotations

import os
import sys

import numpy as np

from . import _common as C


def run(device=None, out=None):
    """Returns {"followed", "exact", "ev", "status", "wall"}."""
    from .. import (TorchVector, find_nearest, get_pick_function_maxOvlp,
                    inexactLanczosDiagonalization)
    from ..models.bases import SincInfInf

    dev = C.resolve_device(device)
    out = C.out_dir(out)
    N = 45
    sinc = SincInfInf(SincInfInf.getOptions(N=N, xRange=[-10, 10]))
    H = -sinc.mat_dx2 + np.diag(sinc.xi ** 2)   # eigenvalues 1, 3, 5, ...
    evE, uvE = np.linalg.eigh(H)

    sigma = 13.1
    idx = find_nearest(evE, sigma)[0]
    options = {"linearSystemArgs": {
        "linearSolver": "minres", "linearIter": 30000, "linear_tol": 1e-4}}
    # follow the SECOND-nearest state (past the nearer root)
    ref = TorchVector(uvE[:, idx + 1], options, device=dev)
    pick = get_pick_function_maxOvlp(ref)

    rng = np.random.RandomState(13)
    Y0 = TorchVector(rng.rand(N), options, device=dev)
    with C.Wall(dev) as w:
        ev, uv, status = inexactLanczosDiagonalization(
            H, Y0, sigma, L=16, maxit=200, eConv=1e-10, pick=pick,
            writeOut=True,
            outFileName=os.path.join(out, "iterations_lanczos.out"),
            summaryFileName=os.path.join(out, "summary_lanczos.out"))

    print(f"followed state energy : {ev[0]:.10f}")
    print(f"reference energy      : {evE[idx + 1]:.10f}")
    print(f"converged             : {status['isConverged']}")
    print(f"wall                  : {w.s:.2f} s")
    return {"followed": float(np.real(ev[0])), "exact": float(evE[idx + 1]),
            "ev": np.asarray(ev), "status": status, "wall": w.s}


def main(argv=None):
    args = C.parser(__doc__, out=True).parse_args(argv)
    run(device=C.device_arg(args), out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
