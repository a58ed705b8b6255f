"""Diagnose the production-FEAST contour filter quality on the CH3CN tree.

For one quadrature node z in the nu8 window (zpve + 361 + 3i cm-1), run the
TTNS contour solve with (a) a random complex maxD=3 guess, (b) the two
"bright state" basis guesses (|0..1_bend..0> HO product states on the
fused [x11 x12] leaf), and report:
  - the true relative residual ||(zI-H)x - b|| / ||b|| (computed via TTNO
    apply + linear combination at a generous fit bond, 40),
  - the Rayleigh quotient of the filtered vector (it falls toward the
    window if the filter acts).

Run:  python -m eigensolvers_tpu_torch.tools.diag_feast_filter [N] [--cpu]
                                                               (default 8)
On the card unless ``--cpu``; it writes no file.
"""

from __future__ import annotations

import copy
import sys

import numpy as np

from ..examples import _common as C

MAXD = 3
EPS = 5e-9
# zpve for the N=8 tree from the committed records (9837.x); a recompute is
# expensive, the known band is used instead
ZPVE_CM = 9837.45
SHIFT_CM, ETA_CM = 361.0, 3.0


def run(N=8, device=None):
    """Returns {"z", "rows": [{name, guess_rq_cm1, rel_res, filtered_rq_cm1,
    norm_x, wall}]}."""
    from ..models.molecules import ch3cn_tree_operator
    from ..utils.units import au2unit, unit2au
    from ..vectors.ttns import TTNSVector

    dev = C.resolve_device(device)
    op, topo, parts, _ = ch3cn_tree_operator(N=N, device=dev)
    dims = [int(N ** len(p)) for p in parts]
    opts = {"compressArgs": {"maxD": MAXD, "eps": EPS},
            "stateFittingArgs": {"maxD": 20, "eps": EPS},
            "linearSystemArgs": {"method": "als", "nSweep": 30,
                                 "convTol": 1e-4, "siteTol": 1e-5,
                                 "linearIter": 150, "linear_tol": 1e-4,
                                 "maxD": MAXD, "eps": EPS}}
    z = complex(unit2au(ZPVE_CM + SHIFT_CM, "cm-1"),
                unit2au(ETA_CM, "cm-1"))

    def product_state(excite_node=None, excite_idx=0):
        # product basis state: all bonds 1; node tensor (1, dims[i], 1..1)
        ts = []
        for i in range(len(topo)):
            shape = (1, int(dims[i])) + (1,) * len(topo.children[i])
            t = np.zeros(shape, np.complex128)
            phys = excite_idx if i == excite_node else 0
            t[(0, phys) + (0,) * len(topo.children[i])] = 1.0
            ts.append(t)
        return TTNSVector(ts, opts, topo=topo, device=dev).normalize()

    # the nu8 bend pair lives on the fused [x11 x12] leaf
    bend = next(i for i, p in enumerate(parts) if p == [10, 11])
    guesses = {
        "random": TTNSVector.random(topo, dims, maxD=MAXD, options=opts,
                                    seed=20, dtype=np.complex128,
                                    device=dev),
        "bright x11=1": product_state(bend, 1 * N),
        "bright x12=1": product_state(bend, 1),
    }

    wide = copy.deepcopy(opts)
    wide["compressArgs"] = {"maxD": 40, "eps": 1e-12}

    rows = []
    for name, y in guesses.items():
        y = y.normalize()
        rq0 = float(np.real(TTNSVector.matrixRepresentation(op, [y])[0, 0]))
        print(f"[{name}] guess RQ: {au2unit(rq0, 'cm-1'):.1f} cm-1 "
              f"(window center {ZPVE_CM + SHIFT_CM:.1f})", flush=True)
        with C.Wall(dev) as w:
            x = TTNSVector.solve(op, y, z, opType="gen")
        # true residual at a generous bond: r = (zI-H)x - y
        xw = TTNSVector(x.tensors, wide, topo=topo)
        yw = TTNSVector(y.tensors, wide, topo=topo)
        hx = xw.applyOp(op)
        r = TTNSVector.linearCombination([xw * z, hx, yw],
                                         [1.0, -1.0, -1.0])
        rel = float(r.norm() / y.norm())
        nx = float(x.norm())
        rqx = float(np.real(TTNSVector.matrixRepresentation(op, [x])[0, 0])
                    / nx ** 2)
        print(f"[{name}] solve {w.s:.0f}s  rel res {rel:.3e}  "
              f"filtered RQ {au2unit(rqx, 'cm-1'):.1f} cm-1  "
              f"|x| {nx:.3e}", flush=True)
        rows.append(dict(name=name, guess_rq_cm1=float(au2unit(rq0, "cm-1")),
                         rel_res=rel,
                         filtered_rq_cm1=float(au2unit(rqx, "cm-1")),
                         norm_x=nx, wall=w.s))
    return {"z": z, "rows": rows}


def main(argv=None):
    ap = C.parser(__doc__)
    ap.add_argument("N", nargs="?", type=int, default=8)
    args = ap.parse_args(argv)
    run(args.N, device=C.device_arg(args))
    return 0


if __name__ == "__main__":
    sys.exit(main())
