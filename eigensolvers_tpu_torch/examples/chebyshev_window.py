"""Chebyshev-filtered window search: the solve-free alternative to FEAST.

The problem and window of ``feast_window``, with the rational contour
filter replaced by a Jackson-damped Chebyshev polynomial of the operator:
each outer iteration is a chain of batched applies, no linear solves.
Run: python -m eigensolvers_tpu_torch.examples.chebyshev_window [--cpu]
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
    from .. import (TorchVector, chebyshevFilteredDiagonalization,
                    select_within_range)
    from ..models.synthetic import known_spectrum_matrix

    dev = C.resolve_device(device)
    out = C.out_dir(out)
    n, m0 = 100, 6
    H, ev = known_spectrum_matrix(n, eigenvalues=np.linspace(1, 200, n),
                                  seed=10)
    ev_min, ev_max = 160.0, 166.0
    Y0 = la.qr(np.random.RandomState(3).rand(n, m0), mode="economic")[0]
    Y = [TorchVector(Y0[:, i], {}, device=dev) for i in range(m0)]

    exact = select_within_range(ev, ev_min, ev_max)[0]
    print("--- actual eigenvalues", exact, "---\n")
    with C.Wall(dev) as w:
        evC, uvC, status = chebyshevFilteredDiagonalization(
            H, Y, 150, ev_min, ev_max, 1e-10, 40, writeOut=True,
            outFileName=os.path.join(out, "iterations_feast.out"),
            summaryFileName=os.path.join(out, "summary_feast.out"))
    got = np.sort(select_within_range(np.asarray(evC), ev_min, ev_max)[0])
    print("\n--- chebyshev eigenvalues", got, "---")
    print("converged:", status["isConverged"],
          "| outer iterations:", status["outerIter"] + 1,
          "| filter degree:", status["degree"],
          "| estimated spectral bounds:",
          tuple(round(x, 2) for x in status["specBounds"]))
    print(f"wall {w.s:.2f} s")
    return {"ev": got, "exact": np.asarray(exact), "status": status,
            "wall": w.s}


def main(argv=None):
    args = C.parser(__doc__, out=True).parse_args(argv)
    run(device=C.device_arg(args), out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
