"""Pyrazine 4-mode vibronic model from the MCTDH operator file: targeted
Lanczos on an interior vibronic state (a dense-feasible cut), levels in eV.

The role of the reference's TTNS example drivers on the bundled pyr4+.op
model (N = 5 per mode, dim 1,250).
Run: python -m eigensolvers_tpu_torch.examples.pyrazine_vibronic [--cpu]
     [--out DIR]
"""

from __future__ import annotations

import os
import sys

import numpy as np

from . import _common as C


def run(device=None, out=None):
    """Returns {"level", "exact" (a.u.), "ev", "status", "wall"}."""
    from .. import TorchVector, find_nearest, inexactLanczosDiagonalization
    from ..models.molecules import pyrazine4_operator
    from ..utils.units import au2unit

    dev = C.resolve_device(device)
    out = C.out_dir(out)
    op, spec, bases = pyrazine4_operator(N=5, device=dev)
    print(f"model: {spec.title}")
    print(f"modes: {spec.mode_labels}, terms: {len(spec.terms)}, "
          f"dim: {op.shape[0]}")

    H = op.to_dense()
    H = np.asarray(H.cpu() if hasattr(H, "cpu") else H)
    evE = np.linalg.eigvalsh(H)
    sigma = float(evE[6] + 0.25 * (evE[7] - evE[6]))

    rng = np.random.RandomState(11)
    options = {"linearSystemArgs": {
        "linearSolver": "gmres", "linearIter": 3000, "linear_tol": 1e-3,
        "errorOnNonConvergence": False}}
    Y0 = TorchVector(rng.rand(*[b.N for b in bases]), options, device=dev)
    with C.Wall(dev) as w:
        ev, uv, status = inexactLanczosDiagonalization(
            op, Y0, sigma, L=20, maxit=10, eConv=1e-8, writeOut=True,
            convertUnit="ev",
            outFileName=os.path.join(out, "iterations_lanczos.out"),
            summaryFileName=os.path.join(out, "summary_lanczos.out"))

    got = float(np.real(find_nearest(ev, sigma)[1]))
    want = float(find_nearest(evE, sigma)[1])
    print(f"target state: {float(au2unit(got, 'ev')):.6f} eV "
          f"(exact {float(au2unit(want, 'ev')):.6f} eV)")
    print("converged:", status["isConverged"])
    print(f"wall {w.s:.2f} s")
    return {"level": got, "exact": want, "ev": np.asarray(ev),
            "status": status, "wall": w.s}


def main(argv=None):
    args = C.parser(__doc__, out=True).parse_args(argv)
    run(device=C.device_arg(args), out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
