"""CH3CN production-basis bond-dimension ladder: variational ZPVE vs maxD.

The targeted-Lanczos production run (examples/ch3cn_production.py) converges
the N=42/mode chain at maxD=10 to ~0.07 cm-1 ABOVE the reference's production
value (reference: examples/ttns2_ch3cn.py:25-34, zpve 9837.4069 cm-1 at
maxD=10 on a TTNS tree).  Both numbers are variational upper bounds, so the
gap closes from above by raising maxD: this ladder re-optimizes the converged
N=42 state by two-site DMRG at increasing maxD, seeded rung to rung.

Run:  python -m eigensolvers_tpu_torch.examples.ch3cn_maxd_ladder [maxD ...]
          [--seed-maxd D0] [--seed-dir DIR] [--cpu] [--out DIR]
                                                      (default 10 12 14 16)
Env:  CH3CN_N (default 42), CH3CN_SWEEPS (default 8)
Outputs (under --out, default build/artifacts/): one ``"kind":
"maxd_ladder"`` record per rung in ch3cn_production.jsonl and the rung
states ch3cn_state_N{N}_D{maxD}.npz; a rerun resumes from the output's own
completed rungs.  The seed is the committed production state
artifacts/ch3cn_state_N{N}.npz (read only; ``--seed-dir`` for another
directory), or with ``--seed-maxd D0`` the committed rung state
ch3cn_state_N{N}_D{D0}.npz.
"""

from __future__ import annotations

import os
import sys
import time

from . import _common as C


def done_rungs(out, N):
    return {int(d["maxD"]): d
            for d in C.read_records(os.path.join(out, C.LOG_NAME))
            if d.get("kind") == "maxd_ladder" and int(d["N"]) == N}


def state_path(d, N, D=None):
    tail = "" if D is None else f"_D{D}"
    return os.path.join(d, f"ch3cn_state_N{N}{tail}.npz")


def run(Ds=(10, 12, 14, 16), N=42, nSweep=8, device=None, out=None,
        seed_maxd=None, seed_dir=None):
    """Returns {"mpo_bonds", "seed", "rungs": [{maxD, record, zpve_cm1,
    wall, state}]}; ``seed`` names the state the ladder started from (None
    for a random start)."""
    from ..models.molecules import ch3cn_operator
    from ..utils.units import au2unit
    from ..vectors.mps import MPO
    from ..vectors.mps_sweeps import dmrg_eigensolve

    dev = C.resolve_device(device)
    out = C.out_dir(out)
    done = done_rungs(out, N)

    t0 = time.time()
    op, _, _ = ch3cn_operator(N=N, device=dev)
    mpo = MPO.from_sop_compressed(op)
    bonds = [int(t.shape[0]) for t in mpo.tensors]
    print(f"N={N} MPO bonds {bonds} [{time.time() - t0:.0f}s]", flush=True)

    # seed: the targeted-Lanczos production state (maxD=10), a committed
    # ladder rung (--seed-maxd), or the largest rung completed in --out
    src = C.ART if seed_dir is None else seed_dir
    x0, seed = None, None
    if seed_maxd is None:
        if os.path.exists(state_path(src, N)):
            seed = state_path(src, N)
            print(f"seeded from production Lanczos state {seed}", flush=True)
    else:
        seed = state_path(src, N, seed_maxd)
        if not os.path.exists(seed):
            raise FileNotFoundError(f"--seed-maxd {seed_maxd}: no {seed}")
        print(f"seeded from ladder rung maxD={seed_maxd} ({seed})",
              flush=True)
    if seed is not None:
        x0 = [t.astype("float64") for t in C.load_tensors(seed)]
    for D in sorted(done):
        if os.path.exists(state_path(out, N, D)):
            x0 = C.load_tensors(state_path(out, N, D))
            seed = state_path(out, N, D)
            print(f"resuming ladder from completed maxD={D}", flush=True)

    rungs = []
    for D in Ds:
        if D in done:
            print(f"maxD={D}: already done "
                  f"(zpve {done[D]['zpve_cm1']:.4f} cm-1), skipping",
                  flush=True)
            continue
        with C.Wall(dev) as w:
            es, xs = dmrg_eigensolve(mpo.tensors, [N] * 12, x0=x0,
                                     nStates=1, maxD=D, nSweep=nSweep,
                                     convTol=1e-11, seed=1)
        zpve = float(au2unit(float(es[0]), "cm-1"))
        rec = {"kind": "maxd_ladder", "N": N, "maxD": D, "nSweep": nSweep,
               "zpve_cm1": round(zpve, 4),
               "err_vs_ref_cm1": round(zpve - C.REF_ZPVE_CM1, 4),
               "ref_cm1": C.REF_ZPVE_CM1,
               "beats_reference": bool(zpve < C.REF_ZPVE_CM1),
               "wall_s": round(w.s, 1),
               "state_maxD": int(max(t.shape[0] for t in xs[0]))}
        C.append_record(out, rec)
        print(f"maxD={D}: ZPVE {zpve:.4f} cm-1 "
              f"(ref {C.REF_ZPVE_CM1}, err {zpve - C.REF_ZPVE_CM1:+.4f}, "
              f"beats_reference={rec['beats_reference']}) [{w.s:.0f}s]"
              f"{C.peak_memory(dev)}", flush=True)
        x0 = [C.to_numpy(t) for t in xs[0]]
        C.save_tensors(state_path(out, N, D), x0)
        rungs.append(dict(maxD=D, record=rec, zpve_cm1=zpve, wall=w.s,
                          state=x0))
    return {"mpo_bonds": bonds, "seed": seed, "rungs": rungs}


def main(argv=None):
    ap = C.parser(__doc__, out=True)
    ap.add_argument("Ds", nargs="*", type=int, default=[10, 12, 14, 16])
    ap.add_argument("--seed-maxd", type=int, default=None,
                    help="start from the committed ladder rung of this maxD")
    ap.add_argument("--seed-dir", default=None,
                    help="where the seed state is (default artifacts/)")
    args = ap.parse_args(argv)
    run(args.Ds or [10, 12, 14, 16],
        N=int(os.environ.get("CH3CN_N", "42")),
        nSweep=int(os.environ.get("CH3CN_SWEEPS", "8")),
        device=C.device_arg(args), out=args.out, seed_maxd=args.seed_maxd,
        seed_dir=args.seed_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
