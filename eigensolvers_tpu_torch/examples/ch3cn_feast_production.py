"""CH3CN FEAST over the nu8 (CCN bend) fundamental window on the
reference's production tree.

The reference's FEAST TTNS setup (examples/feast_ttns2_ch3cn.py): nc = 6
Gauss-Legendre half-contour, m0 = 4 complex tree guesses, MAX_D = 3 for
the contour solves with a fitting bond of 20, eConv 1e-6, maxit 3, the
contour solves run to the sweeps' convergence (convTol 1e-4, early stop).
The default window [zpve + 350, zpve + 372] cm-1 holds the nu8 pair that
``ch3cn_excited_production`` converges: an independent cross-check.  The
zpve is the committed tree record's for this N (then the output's own).

Guesses: the two BRIGHT basis states (one quantum on the fused bend leaf,
x11 or x12), padded with random complex trees (seeds 20+i) to m0 = 4: at
42^12 a random bond-3 tree carries ~1e-10 of the in-window pair, and the
bond-3 contour solves floor the filter's suppression at ~1e-2 per
iteration, so random seeding cannot converge the window in 3 iterations.

Run:  python -m eigensolvers_tpu_torch.examples.ch3cn_feast_production [N]
          [--cpu] [--out DIR]                                (default 42)
Env:  CH3CN_FEAST_MAXD (3), CH3CN_FEAST_NC (6), CH3CN_FEAST_MAXIT (3),
      CH3CN_FEAST_WINDOW ("350,372" in cm-1 above zpve),
      CH3CN_FEAST_NSWEEP (30, early-stopped at convTol=1e-4)
Outputs (under --out): {"kind": "feast_window", ...} in
ch3cn_production.jsonl, ch3cn_tree_feast_N{N}_s{i}.npz,
iterations_/summary_ch3cn_feast_N{N}.out.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from . import _common as C

M0 = 4                     # reference N_SUBSPACE=4
ECONV = 1e-6               # reference eps
FIT_MAXD = 20              # reference bondAdaptFitting maxD=20
EPS = 5e-9                 # reference EPS


def run(N=42, maxD=3, nc=6, maxit=3, window=(350.0, 372.0), nSweep=30,
        device=None, out=None):
    """Returns {"in_window_cm1", "all_ritz_cm1", "record", "status",
    "wall"}."""
    from .. import TTNSVector, feastDiagonalization, select_within_range
    from ..models.molecules import ch3cn_tree_operator
    from ..utils.units import au2unit, unit2au

    dev = C.resolve_device(device)
    out = C.out_dir(out)
    e_lo_cm, e_hi_cm = (float(x) for x in window)
    zpve = C.rung_zpve_cm1(N, out)
    if zpve is None:
        raise ValueError(f"no tree zpve record for N={N}; run "
                         f"ch3cn_tree_production first")

    t0 = time.time()
    op, topo, parts, _ = ch3cn_tree_operator(N=N, device=dev)
    print(f"# CH3CN tree N={N} operator built [{time.time() - t0:.0f}s]",
          flush=True)

    zpve_au = float(unit2au(zpve, "cm-1"))
    eMin = float(unit2au(zpve + e_lo_cm, "cm-1"))
    eMax = float(unit2au(zpve + e_hi_cm, "cm-1"))
    # solves truncate at MAX_D; Q accumulation and the basis transformation
    # fit at the reference's larger fitting budget
    opts = {"compressArgs": {"maxD": maxD, "eps": EPS},
            "stateFittingArgs": {"maxD": FIT_MAXD, "eps": EPS},
            "linearSystemArgs": {"method": "als", "nSweep": nSweep,
                                 "convTol": 1e-4, "siteTol": 1e-5,
                                 "linearIter": 150, "linear_tol": 1e-4,
                                 "maxD": maxD, "eps": EPS}}
    dims = [int(N ** len(p)) for p in parts]
    bend = next(i for i, p in enumerate(parts) if p == [10, 11])

    def product_state(excite_idx):
        ts = []
        for i in range(len(topo)):
            shape = (1, int(dims[i])) + (1,) * len(topo.children[i])
            t = np.zeros(shape, np.complex128)
            phys = excite_idx if i == bend else 0
            t[(0, phys) + (0,) * len(topo.children[i])] = 1.0
            ts.append(t)
        return ts

    Y = [TTNSVector(product_state(1 * N), opts, topo=topo,
                    device=dev).normalize(),
         TTNSVector(product_state(1), opts, topo=topo,
                    device=dev).normalize()]
    Y += [TTNSVector.random(topo, dims, maxD=maxD, options=opts, seed=20 + i,
                            dtype=np.complex128, device=dev)
          for i in range(M0 - len(Y))]
    Y = TTNSVector.orthogonalize(Y)
    if len(Y) != M0:
        raise RuntimeError("guess set collapsed")

    with C.Wall(dev) as w:
        ev, uv, status = feastDiagonalization(
            op, Y, nc, "legendre", eMin, eMax, ECONV, maxit,
            eShift=zpve_au, convertUnit="cm-1", writeOut=True,
            outFileName=os.path.join(out, f"iterations_ch3cn_feast_N{N}.out"),
            summaryFileName=os.path.join(out,
                                         f"summary_ch3cn_feast_N{N}.out"))

    evr = np.real(np.asarray(ev))
    got = np.sort(select_within_range(evr, eMin, eMax)[0])
    got_cm = [round(float(au2unit(e, "cm-1")) - zpve, 4) for e in got]
    all_cm = [round(float(au2unit(e, "cm-1")) - zpve, 4)
              for e in np.sort(evr)]
    rec = {"kind": "feast_window", "topology": "tree", "N": N,
           "maxD": maxD, "fit_maxD": FIT_MAXD, "nc": nc, "m0": M0,
           "maxit": maxit, "eConv": ECONV,
           "window_cm1": [e_lo_cm, e_hi_cm], "zpve_cm1": zpve,
           "in_window_cm1": got_cm, "all_ritz_cm1": all_cm,
           "converged": bool(status.get("isConverged")),
           # a run of one outer iteration has no residual yet (None)
           "residual": float(np.nan if status.get("residual") is None
                             else status["residual"]),
           "wall_s": round(w.s, 1),
           "state_maxD": int(max(v.maxD for v in uv))}
    C.append_record(out, rec)
    print(f"# FEAST window [{e_lo_cm}, {e_hi_cm}] cm-1 above zpve at N={N}: "
          f"found {got_cm} (all Ritz: {all_cm}) "
          f"converged={rec['converged']} residual={rec['residual']:.2e} "
          f"[{w.s:.0f}s]", flush=True)
    for i, v in enumerate(uv[:len(got)]):
        C.save_tensors(os.path.join(out, f"ch3cn_tree_feast_N{N}_s{i}.npz"),
                       v.tensors)
    return {"in_window_cm1": got_cm, "all_ritz_cm1": all_cm, "record": rec,
            "status": status, "wall": w.s}


def main(argv=None):
    ap = C.parser(__doc__, out=True)
    ap.add_argument("N", nargs="?", type=int, default=42)
    args = ap.parse_args(argv)
    env = os.environ.get
    run(args.N, maxD=int(env("CH3CN_FEAST_MAXD", "3")),
        nc=int(env("CH3CN_FEAST_NC", "6")),
        maxit=int(env("CH3CN_FEAST_MAXIT", "3")),
        window=env("CH3CN_FEAST_WINDOW", "350,372").split(","),
        nSweep=int(env("CH3CN_FEAST_NSWEEP", "30")),
        device=C.device_arg(args), out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
