"""Spectrum slicing: every eigenpair in a wide interval through
load-balanced FEAST windows and a batched inverse-iteration polish.

A KPM density estimate (one Chebyshev recurrence) sizes and balances the
windows, each window runs batched-contour FEAST, and the merged pairs are
polished (n = 400, [200.25, 320.25]).
Run: python -m eigensolvers_tpu_torch.examples.spectrum_slicing [--cpu]
"""

from __future__ import annotations

import sys

import numpy as np

from . import _common as C


def run(device=None, n=400, interval=(200.25, 320.25)):
    """Returns {"ev", "exact", "status", "max_err", "wall"}; ``n`` and
    ``interval`` default to the example's (smaller ones for tests)."""
    from .. import spectrumSlicingDiagonalization
    from ..models.synthetic import known_spectrum_matrix

    dev = C.resolve_device(device)
    H, ev = known_spectrum_matrix(n, eigenvalues=np.linspace(1, 2 * n, n),
                                  seed=10)
    H = np.asarray(H)
    eMin, eMax = interval
    exact = ev[(ev >= eMin) & (ev <= eMax)]
    print(f"interval [{eMin}, {eMax}]: {len(exact)} true eigenvalues")

    with C.Wall(dev) as w:
        ev_s, vec_s, st = spectrumSlicingDiagonalization(
            H, eMin, eMax, nc=8, eConv=1e-8, maxit=12, seed=3, device=dev)
    ev_s = np.asarray(ev_s)

    print(f"windows: {len(st['windows'])}  "
          f"(KPM estimated total {st['estimated_total']:.1f})")
    for win in st["windows"]:
        lo, hi = win["window"]
        print(f"  [{lo:8.3f}, {hi:8.3f}]  est {win['estimated']:5.1f}  "
              f"m0 {win['m0']:3d}  found {win['found']}")
    print(f"found {st['found_total']} / {len(exact)}  "
          f"(dropped {st['dropped_spurious']} spurious)")
    err = (float(np.abs(ev_s - exact).max()) if len(ev_s) == len(exact)
           else float("inf"))
    print(f"max |ev err|: {err:.2e}   "
          f"max residual: {np.asarray(st['residuals']).max():.2e}")
    print(f"converged: {st['isConverged']} "
          f"(residual-certified: {st['residual_certified']})")
    print(f"wall {w.s:.2f} s")
    return {"ev": ev_s, "exact": exact, "status": st, "max_err": err,
            "wall": w.s}


def main(argv=None):
    args = C.parser(__doc__).parse_args(argv)
    run(device=C.device_arg(args))
    return 0


if __name__ == "__main__":
    sys.exit(main())
