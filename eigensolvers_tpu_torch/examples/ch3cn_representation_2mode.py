"""Dense-feasible quantification of the CH3CN FBR-vs-DVR representation
offset.

Production context: the 12-mode chain at N=42/mode converges to
9837.479 cm-1 in HO-FBR (quadrature-exact polynomial integrals) vs the
reference's HO-DVR-based production value 9837.4069, an offset that does
not move with bond dimension (the maxd_ladder records) and therefore lives
in the operator representation.  The full N=42 DVR operator even has
collapsed negative-energy states (the polynomial PES turns over beyond the
physical region; the "representation" record measures a DMRG collapse to
-5.5e5 cm-1).

This script isolates the effect where dense diagonalization is exact: the
2-mode (x1, x2) cut of the same PES.  For each representation it
diagonalizes the 2-mode Hamiltonian (on the device, f64) at N per mode
against a quasi-exact oracle (FBR at N=80, where the truncated-basis error
is negligible), printing the ZPVE error per representation and N; then
the 4- and 6-mode cuts at N=42 by DMRG in both representations.

Run:  python -m eigensolvers_tpu_torch.examples.ch3cn_representation_2mode
          [--mode-cuts K ...] [--maxd D] [--cpu] [--out DIR]
                                       (default: cuts 4 6 at maxD 24)
Outputs: a {"kind": "representation_2mode", ...} record appended to
ch3cn_production.jsonl under --out (default build/artifacts/).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from . import _common as C


def two_mode_dense(N, representation, device=None):
    """Dense 2-mode-cut Hamiltonian (N^2 x N^2, f64) in the given
    representation, on ``device``."""
    from ..models.molecules import ch3cn_operator

    op, _, _ = ch3cn_operator(N=N, nModesCut=2,
                              representation=representation,
                              device=C.resolve_device(device))
    return op.to_dense().to(torch.float64)


def run(oracle_N=80, Ns=(14, 28, 42), mode_cuts=(4, 6), N_dmrg=42,
        maxD=24, nSweep=6, device=None, out=None):
    """Returns {"oracle_cm1", "rows", "record", "dmrg_cm1": {(k, rep):
    zpve}, "walls": {"dense", "k-mode rep"}}; ``mode_cuts`` may be empty
    (the dense part only)."""
    from ..models.molecules import ch3cn_operator
    from ..utils.units import au2unit
    from ..vectors.mps import MPO
    from ..vectors.mps_sweeps import dmrg_eigensolve

    dev = C.resolve_device(device)
    out = C.out_dir(out)
    walls, dmrg_cm1 = {}, {}

    # quasi-exact oracle: FBR at N=80 (variational in the HO basis;
    # doubling 40 -> 80 changes the 2-mode zpve by < 1e-9 cm-1)
    with C.Wall(dev) as w:
        H_oracle = two_mode_dense(oracle_N, "fbr", dev)
        e_oracle = float(torch.linalg.eigvalsh(H_oracle)[0])
        del H_oracle
        zpve_oracle = float(au2unit(e_oracle, "cm-1"))
        print(f"oracle (FBR N={oracle_N}) 2-mode zpve: {zpve_oracle:.6f} "
              f"cm-1", flush=True)

        rows = []
        for rep in ("fbr", "dvr"):
            for N in Ns:
                evs = torch.linalg.eigvalsh(two_mode_dense(N, rep, dev))
                evs = evs.cpu().numpy()
                # the DVR turnover may create collapsed states below the
                # physical ground state: report the eigenvalue nearest the
                # oracle as the physical zpve, plus the global minimum
                k = int(np.argmin(np.abs(evs - e_oracle)))
                zpve = float(au2unit(float(evs[k]), "cm-1"))
                e_min = float(au2unit(float(evs[0]), "cm-1"))
                row = {"representation": rep, "N": N,
                       "zpve_cm1": round(zpve, 6),
                       "err_vs_oracle_cm1": round(zpve - zpve_oracle, 6),
                       "lowest_state_cm1": round(e_min, 4),
                       "n_collapsed_below": int(k)}
                rows.append(row)
                print(f"  {rep} N={N}: zpve {zpve:.6f} "
                      f"(err {zpve - zpve_oracle:+.6f}) "
                      f"lowest state {e_min:.1f} "
                      f"({k} collapsed below)", flush=True)
    walls["dense"] = w.s

    # mode ladder: the 2-mode cut is benign (identical to 1e-6 cm-1); the
    # DVR anomaly must enter through higher-mode couplings.
    for k in mode_cuts:
        zp = {}
        for rep in ("fbr", "dvr"):
            op, _, _ = ch3cn_operator(N=N_dmrg, nModesCut=k,
                                      representation=rep, device=dev)
            mpo = MPO.from_sop_compressed(op)
            with C.Wall(dev) as w:
                es, _ = dmrg_eigensolve(mpo.tensors, [N_dmrg] * k,
                                        nStates=1, maxD=maxD, nSweep=nSweep,
                                        convTol=1e-12, seed=1)
            walls[f"{k}-mode {rep}"] = w.s
            zp[rep] = dmrg_cm1[k, rep] = float(au2unit(float(es[0]),
                                                       "cm-1"))
            print(f"  {k}-mode {rep} N={N_dmrg}: zpve {zp[rep]:.6f}",
                  flush=True)
        row = {"representation": "dvr-vs-fbr", "nModes": k, "N": N_dmrg,
               "zpve_fbr_cm1": round(zp["fbr"], 6),
               "zpve_dvr_cm1": round(zp["dvr"], 6),
               "dvr_minus_fbr_cm1": round(zp["dvr"] - zp["fbr"], 6)}
        rows.append(row)
        print(f"  {k}-mode DVR-FBR offset: "
              f"{zp['dvr'] - zp['fbr']:+.6f} cm-1", flush=True)

    rec = {"kind": "representation_2mode",
           f"oracle_fbr_N{oracle_N}_cm1": round(zpve_oracle, 6),
           "rows": rows}
    C.append_record(out, rec)
    print(f"walls: {', '.join(f'{k} {v:.1f} s' for k, v in walls.items())}"
          f"{C.peak_memory(dev)}", flush=True)
    return {"oracle_cm1": zpve_oracle, "rows": rows, "record": rec,
            "dmrg_cm1": dmrg_cm1, "walls": walls}


def main(argv=None):
    ap = C.parser(__doc__, out=True)
    ap.add_argument("--mode-cuts", nargs="*", type=int, default=[4, 6],
                    help="the DMRG rows' mode cuts at N=42")
    ap.add_argument("--maxd", type=int, default=24,
                    help="the DMRG rows' bond dimension")
    args = ap.parse_args(argv)
    run(mode_cuts=args.mode_cuts, maxD=args.maxd, device=C.device_arg(args),
        out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
