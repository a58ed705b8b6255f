"""FEAST window search on a dense known-spectrum matrix.

Window [160, 166], nc = 8 Gauss-Legendre nodes (reference: feast.py
__main__ demo).
Run: python -m eigensolvers_tpu_torch.examples.feast_window [--cpu]
     [--out DIR]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import scipy.linalg as la

from . import _common as C


def run(device=None, out=None):
    """Returns {"ev" (in the window, sorted), "exact", "status", "wall"}."""
    from .. import TorchVector, feastDiagonalization, select_within_range
    from ..models.synthetic import known_spectrum_matrix

    dev = C.resolve_device(device)
    out = C.out_dir(out)
    n, m0 = 100, 6
    H, ev = known_spectrum_matrix(n, eigenvalues=np.linspace(1, 200, n),
                                  seed=10)
    ev_min, ev_max = 160.0, 166.0
    options = {"linearSystemArgs": {
        "linearSolver": "gcrotmk", "linearIter": 1000, "linear_tol": 1e-2,
        "errorOnNonConvergence": False}}
    Y0 = np.stack([np.ones(n) * (i + 1) for i in range(m0)], axis=1)
    Y1 = la.qr(Y0, mode="economic")[0]
    Y = [TorchVector(Y1[:, i], options, device=dev) for i in range(m0)]

    exact = select_within_range(ev, ev_min, ev_max)[0]
    print("--- actual eigenvalues", exact, "---\n")
    with C.Wall(dev) as w:
        efeast, ufeast, status = feastDiagonalization(
            H, Y, 8, "legendre", ev_min, ev_max, 1e-6, 10, writeOut=True,
            outFileName=os.path.join(out, "iterations_feast.out"),
            summaryFileName=os.path.join(out, "summary_feast.out"))
    got = np.sort(select_within_range(np.asarray(efeast), ev_min,
                                      ev_max)[0])
    print("\n--- feast eigenvalues", got, "---")
    print("converged:", status["isConverged"])
    print(f"wall {w.s:.2f} s")
    return {"ev": got, "exact": np.asarray(exact), "status": status,
            "wall": w.s}


def main(argv=None):
    args = C.parser(__doc__, out=True).parse_args(argv)
    run(device=C.device_arg(args), out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
