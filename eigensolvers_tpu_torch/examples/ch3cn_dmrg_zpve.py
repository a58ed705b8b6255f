"""CH3CN 12-mode zero-point energy by two-site DMRG on the chain.

MCTDH .op file -> grouped SoP operator -> bond-compressed MPO -> DMRG
eigensweep at a modest bond (dense dimension N^12; the reference's
production zpve is 9837.4069 cm-1, examples/ttns2_ch3cn.py:25-34).
Run: python -m eigensolvers_tpu_torch.examples.ch3cn_dmrg_zpve [N] [maxD]
     [--cpu]                                          (default 20 10)
"""

from __future__ import annotations

import sys
import time

from . import _common as C


def run(N=20, maxD=10, device=None):
    """Returns {"zpve_cm1", "mpo_bonds", "wall"}."""
    from ..models.molecules import ch3cn_operator
    from ..utils.units import au2unit
    from ..vectors.mps import MPO
    from ..vectors.mps_sweeps import dmrg_eigensolve

    dev = C.resolve_device(device)
    t0 = time.time()
    op, spec, bases = ch3cn_operator(N=N, device=dev)
    print(f"operator: 12 modes x {N} points, {len(spec.terms)} terms, "
          f"dense dim {float(N)**12:.2e}")
    mpo = MPO.from_sop_compressed(op)
    bonds = [int(t.shape[0]) for t in mpo.tensors]
    print(f"MPO bonds: {bonds} ({time.time() - t0:.0f}s)")

    with C.Wall(dev) as w:
        es, xs = dmrg_eigensolve(mpo.tensors, [N] * 12, nStates=1,
                                 maxD=maxD, nSweep=10, convTol=1e-10, seed=1)
    zpve = float(au2unit(es[0], "cm-1"))
    print(f"ZPVE (maxD={maxD}): {zpve:.4f} cm-1   "
          f"[reference production value 9837.4069]   ({w.s:.0f}s)")
    return {"zpve_cm1": zpve, "mpo_bonds": bonds, "wall": w.s}


def main(argv=None):
    ap = C.parser(__doc__)
    ap.add_argument("N", nargs="?", type=int, default=20)
    ap.add_argument("maxD", nargs="?", type=int, default=10)
    args = ap.parse_args(argv)
    run(args.N, args.maxD, device=C.device_arg(args))
    return 0


if __name__ == "__main__":
    sys.exit(main())
