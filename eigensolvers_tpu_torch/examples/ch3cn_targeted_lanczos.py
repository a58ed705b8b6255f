"""CH3CN chain pipeline: coarse-basis DMRG guess -> exact embedding ->
targeted inexact Lanczos in MPS form at a larger basis (reference config
examples/ttns2_ch3cn.py:25-34, maxD 10, zpve 9837.4069 cm-1).

Targeted because the polynomial force field turns over at large |q|: a
basis large enough to reach the turnover has spurious deep states, which
a global ground-state search (DMRG) falls into; shift-and-invert at sigma
~ zpve suppresses them by 1/(sigma - lambda).  The small guess basis
cannot reach the turnover, so its DMRG is safe.
Run: python -m eigensolvers_tpu_torch.examples.ch3cn_targeted_lanczos
     [N_guess] [N_prod] [maxD] [--cpu] [--out DIR]        (default 8 12 10)
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from . import _common as C


def embed_mps(tensors, n_new):
    """Zero-pad each site tensor's physical dimension to ``n_new`` (the
    HO-basis states keep their identity across basis sizes, so the pad IS
    the exact embedding); a smaller ``n_new`` truncates."""
    out = []
    for t in map(C.to_numpy, tensors):
        Dl, n, Dr = t.shape
        tt = np.zeros((Dl, n_new, Dr), t.dtype)
        tt[:, :min(n, n_new), :] = t[:, :min(n, n_new), :]
        out.append(tt)
    return out


def run(N_guess=8, N_prod=12, maxD=10, device=None, out=None):
    """Returns {"guess_cm1", "zpve_cm1", "ev", "status", "wall"}."""
    from .. import find_nearest, inexactLanczosDiagonalization
    from ..models.molecules import ch3cn_operator
    from ..utils.units import au2unit
    from ..vectors.mps import MPO, MPSVector
    from ..vectors.mps_sweeps import dmrg_eigensolve

    dev = C.resolve_device(device)
    out = C.out_dir(out)
    # 1) coarse-basis DMRG ground state
    t0 = time.time()
    op_g, _, _ = ch3cn_operator(N=N_guess, device=dev)
    mpo_g = MPO.from_sop_compressed(op_g)
    es, xs = dmrg_eigensolve(mpo_g.tensors, [N_guess] * 12, nStates=1,
                             maxD=8, nSweep=5, convTol=1e-8, seed=1)
    sigma = float(es[0])
    guess_cm1 = float(au2unit(sigma, "cm-1"))
    print(f"guess (N={N_guess} DMRG): {guess_cm1:.4f} cm-1 "
          f"[{time.time() - t0:.0f}s]")

    # 2) production-basis operator
    t1 = time.time()
    op_p, _, _ = ch3cn_operator(N=N_prod, device=dev)
    mpo_p = MPO.from_sop_compressed(op_p)
    print(f"N={N_prod} MPO bonds "
          f"{[int(t.shape[0]) for t in mpo_p.tensors]} "
          f"[{time.time() - t1:.0f}s]")

    # 3) targeted inexact Lanczos with ALS inner sweeps, seeded by the
    #    embedded coarse state
    opts = {"compressArgs": {"maxD": maxD, "eps": 1e-10},
            "linearSystemArgs": {"linearSolver": "minres", "method": "als",
                                 "nSweep": 2, "convTol": 1e-4,
                                 "siteTol": 1e-6, "linearIter": 120,
                                 "linear_tol": 1e-3,
                                 "maxD": maxD, "eps": 1e-10}}
    Y0 = MPSVector(embed_mps(xs[0], N_prod), opts, device=dev).normalize()
    with C.Wall(dev) as w:
        ev, uv, status = inexactLanczosDiagonalization(
            mpo_p, Y0, sigma, L=4, maxit=2, eConv=1e-6, writeOut=True,
            outFileName=os.path.join(out, "iterations_lanczos.out"),
            summaryFileName=os.path.join(out, "summary_lanczos.out"))
    zpve = float(au2unit(np.real(find_nearest(ev, sigma)[1]), "cm-1"))
    print(f"N={N_prod} targeted ZPVE: {zpve:.4f} cm-1 "
          f"[reference production value 9837.4069]  "
          f"converged={status['isConverged']} [{w.s:.0f}s]")
    return {"guess_cm1": guess_cm1, "zpve_cm1": zpve, "ev": np.asarray(ev),
            "status": status, "wall": w.s}


def main(argv=None):
    ap = C.parser(__doc__, out=True)
    ap.add_argument("N_guess", nargs="?", type=int, default=8)
    ap.add_argument("N_prod", nargs="?", type=int, default=12)
    ap.add_argument("maxD", nargs="?", type=int, default=10)
    args = ap.parse_args(argv)
    run(args.N_guess, args.N_prod, args.maxD, device=C.device_arg(args),
        out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
