"""CH3CN block inexact Lanczos: a 2-block DMRG-seeded interior eigensolve
in compressed MPS form (reference: examples/ttns2_ch3cn_Block.py:24-31;
production MAX_D 10, N_BLOCK 2, target 360 cm-1 above the zpve, L 10,
maxit 20, eConv 1e-6, EPS 5e-9, DMRG guesses).

  1. DMRG computes the N_BLOCK lowest states as the block guess;
  2. block inexact Lanczos at sigma = zpve + 360 cm-1 with compressed
     sweep solves, reported in cm-1 above the zpve;
  3. the final block states are checkpointed (reference:
     finalLanczosTNSs/) through the backend-neutral checkpoint writer.
Run: python -m eigensolvers_tpu_torch.examples.ch3cn_block_lanczos
     [N] [maxD] [L] [maxit] [--cpu] [--out DIR]        (default 10 8 6 3)
Outputs: iterations_/summary_lanczos.out and finalLanczosMPSs/ under
--out.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from . import _common as C

N_BLOCK = 2                          # reference ttns2_ch3cn_Block.py:25
ECONV = 1e-6
EPS = 5e-9


def run(N=10, maxD=8, L=6, maxit=3, device=None, out=None):
    """Returns {"dmrg_cm1", "ev", "rel_cm1", "status", "checkpoint",
    "wall"}."""
    from .. import inexactLanczosDiagonalization
    from ..models.molecules import ch3cn_operator
    from ..utils.checkpointing import save_checkpoint
    from ..utils.units import au2unit, unit2au
    from ..vectors.mps import MPO, MPSVector
    from ..vectors.mps_sweeps import dmrg_eigensolve

    dev = C.resolve_device(device)
    out = C.out_dir(out)
    t0 = time.time()
    op, _, _ = ch3cn_operator(N=N, device=dev)
    mpo = MPO.from_sop_compressed(op)
    print(f"# CH3CN N={N}: MPO bonds {[int(t.shape[0]) for t in mpo.tensors]}"
          f" [{time.time() - t0:.0f}s]")

    # 1) DMRG block guess
    t1 = time.time()
    es, xs = dmrg_eigensolve(mpo.tensors, [N] * 12, nStates=N_BLOCK,
                             maxD=maxD, nSweep=4, convTol=1e-8, seed=898989)
    dmrg_cm1 = [float(au2unit(e, "cm-1")) for e in es]
    zpve = dmrg_cm1[0]
    print(f"# DMRG guesses: {[f'{e:.2f}' for e in dmrg_cm1]}"
          f" cm-1 (zpve {zpve:.4f}; production reference 9837.4069)"
          f" [{time.time() - t1:.0f}s]")

    # 2) block inexact Lanczos at sigma = zpve + 360 cm-1
    opts = {"compressArgs": {"maxD": maxD, "eps": EPS},
            "linearSystemArgs": {"method": "als", "nSweep": 3,
                                 "convTol": 5e-2, "siteTol": 1e-4,
                                 "linearIter": 150, "linear_tol": 1e-2,
                                 "maxD": maxD, "eps": EPS}}
    guess = [MPSVector([t.clone() for t in x], opts) for x in xs]
    sigma = float(es[0] + unit2au(C.TARGET_CM, "cm-1"))
    with C.Wall(dev) as w:
        ev, uv, status = inexactLanczosDiagonalization(
            op, guess, sigma, L, maxit, ECONV, checkFitTol=1e-3,
            eShift=float(es[0]), convertUnit="cm-1", writeOut=True,
            outFileName=os.path.join(out, "iterations_lanczos.out"),
            summaryFileName=os.path.join(out, "summary_lanczos.out"))
    print(f"# block Lanczos [{w.s:.0f}s] "
          f"converged={status['isConverged']} "
          f"cumIter={status['cumIter']}")
    rel = np.asarray([float(au2unit(np.real(e), "cm-1"))
                      for e in ev]) - zpve
    print(f"# eigenvalues - zpve (cm-1): {np.round(rel, 2)} "
          f"(target {C.TARGET_CM})")

    # 3) checkpoint the final block states (reference: finalLanczosTNSs/)
    ckpt = os.path.join(out, "finalLanczosMPSs")
    save_checkpoint(ckpt, "final", uv, status, eigenvalues=np.asarray(ev))
    print(f"# saved final states to {ckpt}/")
    return {"dmrg_cm1": dmrg_cm1, "ev": np.asarray(ev), "rel_cm1": rel,
            "status": status, "checkpoint": ckpt, "wall": w.s}


def main(argv=None):
    ap = C.parser(__doc__, out=True)
    for name, d in (("N", 10), ("maxD", 8), ("L", 6), ("maxit", 3)):
        ap.add_argument(name, nargs="?", type=int, default=d)
    args = ap.parse_args(argv)
    run(args.N, args.maxD, args.L, args.maxit, device=C.device_arg(args),
        out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
