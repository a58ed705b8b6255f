"""CH3CN N=42: HO-FBR vs HO-DVR representation check.

The production chain runs (examples/ch3cn_production.py, FBR) converge
~0.07 cm-1 ABOVE the reference's production ZPVE and do not move with maxD
(the maxd_ladder rungs), so the offset is an operator-level representation
difference, not bond truncation.  Hypothesis: the reference's HO-DVR grid
(quadrature-approximate polynomial integrals at N=42) vs the default
quadrature-exact FBR matrices.  This script builds the SAME Hamiltonian in
HO-DVR, re-optimizes the converged FBR state by DMRG at maxD=10, and logs
the DVR ZPVE against the reference value 9837.4069 cm-1
(reference: examples/ttns2_ch3cn.py:25-34).

Run:  python -m eigensolvers_tpu_torch.examples.ch3cn_representation_check
          [--cpu] [--out DIR]
Env:  CH3CN_N (42), CH3CN_MAXD (10), CH3CN_REP (dvr)
Outputs: a {"kind": "representation", ...} line appended to
ch3cn_production.jsonl under --out (default build/artifacts/).  The seed is
the committed FBR state artifacts/ch3cn_state_N{N}.npz (read only), where
there is one.
"""

from __future__ import annotations

import os
import sys
import time

from . import _common as C


def run(N=42, maxD=10, rep="dvr", nSweep=12, device=None, out=None):
    """Returns {"zpve_cm1", "record", "mpo_bonds", "seeded", "wall"}."""
    from ..models.molecules import ch3cn_operator
    from ..utils.units import au2unit
    from ..vectors.mps import MPO
    from ..vectors.mps_sweeps import dmrg_eigensolve

    dev = C.resolve_device(device)
    out = C.out_dir(out)

    t0 = time.time()
    op, _, _ = ch3cn_operator(N=N, representation=rep, device=dev)
    mpo = MPO.from_sop_compressed(op)
    bonds = [int(t.shape[0]) for t in mpo.tensors]
    print(f"N={N} rep={rep} MPO bonds {bonds} [{time.time() - t0:.0f}s]",
          flush=True)

    seed_path = os.path.join(C.ART, f"ch3cn_state_N{N}.npz")
    x0 = None
    if os.path.exists(seed_path):
        x0 = [t.astype("float64") for t in C.load_tensors(seed_path)]
        print(f"seeded from FBR production state {seed_path}", flush=True)

    with C.Wall(dev) as w:
        es, _ = dmrg_eigensolve(mpo.tensors, [N] * 12, x0=x0, nStates=1,
                                maxD=maxD, nSweep=nSweep, convTol=1e-11,
                                seed=1)
    zpve = float(au2unit(float(es[0]), "cm-1"))
    rec = {"kind": "representation", "representation": rep, "N": N,
           "maxD": maxD,
           "zpve_cm1": round(zpve, 4),
           "err_vs_ref_cm1": round(zpve - C.REF_ZPVE_CM1, 4),
           "ref_cm1": C.REF_ZPVE_CM1, "wall_s": round(w.s, 1)}
    C.append_record(out, rec)
    print(f"rep={rep} N={N} maxD={maxD}: ZPVE {zpve:.4f} cm-1 "
          f"(ref {C.REF_ZPVE_CM1}, err {zpve - C.REF_ZPVE_CM1:+.4f}) "
          f"[{w.s:.0f}s]{C.peak_memory(dev)}", flush=True)
    return {"zpve_cm1": zpve, "record": rec, "mpo_bonds": bonds,
            "seeded": x0 is not None, "wall": w.s}


def main(argv=None):
    args = C.parser(__doc__, out=True).parse_args(argv)
    run(N=int(os.environ.get("CH3CN_N", "42")),
        maxD=int(os.environ.get("CH3CN_MAXD", "10")),
        rep=os.environ.get("CH3CN_REP", "dvr"), device=C.device_arg(args),
        out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
