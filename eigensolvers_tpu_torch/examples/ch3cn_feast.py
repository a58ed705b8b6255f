"""FEAST on compressed CH3CN: a contour window solve in MPS form (the
reference's FEAST TTNS example, examples/feast_ttns2_ch3cn.py:119: random
orthogonal guesses, Gauss-Legendre nodes, the window in cm-1 above the
zpve).

The compressed backend has no exact addition, so every node runs the TWO
conjugate solves (z and z-bar) with conjugate coefficients (Polizzi
eq. 12; reference feast.py:93-101), as two-site ALS sweeps.  A short DMRG
locates the low-lying states; the window is put around the first excited
multiplet and the FEAST levels are held against the DMRG energies.
Run: python -m eigensolvers_tpu_torch.examples.ch3cn_feast [N] [nModes]
     [maxD] [--cpu] [--out DIR]                          (default 6 5 16)
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from . import _common as C

M0 = 4                               # reference N_SUBSPACE=4
NC = 4                               # quadrature nodes (half-contour)
ECONV = 1e-5
MAXIT = 4


def run(N=6, nModes=5, maxD=16, device=None, out=None):
    """Returns {"dmrg_cm1" (above the zpve), "window_cm1", "found_cm1",
    "errors_cm1" (each in-window DMRG level's distance to the nearest
    FEAST level), "status", "wall"}."""
    from .. import MPSVector, feastDiagonalization, select_within_range
    from ..models.molecules import ch3cn_operator
    from ..utils.units import au2unit, unit2au
    from ..vectors.mps import MPO
    from ..vectors.mps_sweeps import dmrg_eigensolve

    dev = C.resolve_device(device)
    out = C.out_dir(out)
    t0 = time.time()
    op, _, _ = ch3cn_operator(N=N, nModesCut=nModes, device=dev)
    mpo = MPO.from_sop_compressed(op)
    dims = [N] * nModes
    bonds = [int(t.shape[0]) for t in mpo.tensors]
    print(f"# CH3CN N={N} modes={nModes}: MPO bonds {bonds} "
          f"[{time.time() - t0:.0f}s]")

    # locate the window: DMRG for the lowest states
    t1 = time.time()
    es, _ = dmrg_eigensolve(mpo.tensors, dims, nStates=4, maxD=maxD,
                            nSweep=6, convTol=1e-9, seed=20)
    zpve = float(es[0])
    excit = [float(au2unit(e - zpve, "cm-1")) for e in es]
    print(f"# DMRG states (cm-1 above zpve): {np.round(excit, 2)} "
          f"[{time.time() - t1:.0f}s]")

    # window around the first excited multiplet, in cm-1 above the zpve
    # (reference: ev_min/ev_max = unit2au(Emin/Emax + zpve),
    # feast_ttns2:116-117)
    e_lo_cm = excit[1] - 40.0
    e_hi_cm = (excit[3] + excit[1]) / 2 if len(excit) > 3 else excit[1] + 80.0
    eMin = zpve + float(unit2au(e_lo_cm, "cm-1"))
    eMax = zpve + float(unit2au(e_hi_cm, "cm-1"))
    truth = select_within_range(np.asarray(es), eMin, eMax)[0]
    print(f"# window [{e_lo_cm:.1f}, {e_hi_cm:.1f}] cm-1 above zpve: "
          f"{len(truth)} DMRG states inside")

    # random orthogonal compressed guesses (reference: setRandom +
    # orthogonalize, feast_ttns2_ch3cn.py:104-113)
    opts = {"compressArgs": {"maxD": maxD, "eps": 1e-10},
            "linearSystemArgs": {"method": "als", "nSweep": 6,
                                 "convTol": 1e-5, "siteTol": 1e-6,
                                 "linearIter": 150, "linear_tol": 1e-4,
                                 "maxD": maxD, "eps": 1e-10}}
    Y = MPSVector.orthogonalize(
        [MPSVector.random(dims, maxD=8, options=opts, seed=20 + i,
                          device=dev) for i in range(M0)])

    with C.Wall(dev) as w:
        ev, uv, status = feastDiagonalization(
            op, Y, NC, "legendre", eMin, eMax, ECONV, MAXIT,
            eShift=zpve, convertUnit="cm-1", writeOut=True,
            outFileName=os.path.join(out, "iterations_feast.out"),
            summaryFileName=os.path.join(out, "summary_feast.out"))
    got = np.sort(select_within_range(np.real(np.asarray(ev)), eMin,
                                      eMax)[0])
    got_cm = [float(au2unit(e - zpve, "cm-1")) for e in got]
    print(f"# FEAST [{w.s:.0f}s] found {len(got)} in window: "
          f"{np.round(got_cm, 3)} cm-1 above zpve "
          f"(2-solve path: flagAddition={status['flagAddition']})")
    errors = []
    for t in truth:
        err_cm = float(au2unit(min(abs(got - t)), "cm-1")) if len(got) \
            else 9e9
        errors.append(err_cm)
        print(f"#   vs DMRG {float(au2unit(t - zpve, 'cm-1')):9.3f}: "
              f"|err| = {err_cm:.2e} cm-1")
    return {"dmrg_cm1": excit, "window_cm1": (e_lo_cm, e_hi_cm),
            "found_cm1": got_cm, "errors_cm1": errors, "status": status,
            "wall": w.s}


def main(argv=None):
    ap = C.parser(__doc__, out=True)
    for name, d in (("N", 6), ("nModes", 5), ("maxD", 16)):
        ap.add_argument(name, nargs="?", type=int, default=d)
    args = ap.parse_args(argv)
    run(args.N, args.nModes, args.maxD, device=C.device_arg(args),
        out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
