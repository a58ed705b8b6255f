"""CH3CN ZPVE ladder on the chain: targeted inexact Lanczos at N per mode
for N in {14, 28, 42}, maxD 10 (reference: examples/ttns2_ch3cn.py:25-34,
production zpve 9837.4069 cm-1 at N = 42).

Each converged state, zero-padded (the exact embedding of HO-basis
states), seeds the next basis size.  Each rung runs targeted inexact
Lanczos at sigma from an N = 8 DMRG guess, following the embedded state by
maximum overlap, with every iteration checkpointed through the native
writer; it appends one record and keeps its converged MPS so a restarted
run resumes the ladder.

Run:  python -m eigensolvers_tpu_torch.examples.ch3cn_production [N ...]
          [--seed-rung N0] [--cpu] [--out DIR]        (default 14 28 42)
Env:  CH3CN_MAXD (10), CH3CN_MAXIT (2), CH3CN_L (4)
Outputs (under --out, default build/artifacts/): chain records in
ch3cn_production.jsonl, ch3cn_state_N{N}.npz, ch3cn_ckpt_N{N}/,
iterations_/summary_ch3cn_N{N}.out.  ``--seed-rung N0`` starts from the
committed artifacts/ch3cn_state_N{N0}.npz (``--seed-dir`` for others).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from . import _common as C
from .ch3cn_targeted_lanczos import embed_mps

DEFAULTS = dict(maxD=10, maxit=2, L=4)
ENV = dict(maxD=("CH3CN_MAXD", int), maxit=("CH3CN_MAXIT", int),
           L=("CH3CN_L", int))
N_GUESS = 8


def state_path(d, N):
    return os.path.join(d, f"ch3cn_state_N{N}.npz")


def done_rungs(out):
    """The chain rungs of the output's own records (tree and other kinds
    left out: they share the file)."""
    return {int(d["N"]): d
            for d in C.read_records(os.path.join(out, C.LOG_NAME))
            if "N" in d and d.get("topology") is None and "kind" not in d}


def run(Ns=(14, 28, 42), maxD=10, maxit=2, L=4, device=None, out=None,
        seed_rung=None, seed_dir=None):
    """Returns {"guess_cm1", "rungs": [{N, record, ev, status, vector,
    zpve_cm1, wall}]}."""
    from .. import (find_nearest, get_pick_function_maxOvlp,
                    inexactLanczosDiagonalization)
    from ..models.molecules import ch3cn_operator
    from ..utils.units import au2unit
    from ..vectors.mps import MPO, MPSVector
    from ..vectors.mps_sweeps import dmrg_eigensolve

    dev = C.resolve_device(device)
    out = C.out_dir(out)
    done = done_rungs(out)

    # coarse-basis DMRG guess (safe: the small basis cannot reach the PES
    # turnover; see ch3cn_targeted_lanczos)
    t0 = time.time()
    op_g, _, _ = ch3cn_operator(N=N_GUESS, device=dev)
    mpo_g = MPO.from_sop_compressed(op_g)
    es, xs = dmrg_eigensolve(mpo_g.tensors, [N_GUESS] * 12, nStates=1,
                             maxD=8, nSweep=5, convTol=1e-8, seed=1)
    sigma = float(es[0])
    guess_cm1 = float(au2unit(sigma, "cm-1"))
    print(f"guess (N={N_GUESS} DMRG): {guess_cm1:.4f} cm-1 "
          f"[{time.time() - t0:.0f}s]", flush=True)

    opts = {"compressArgs": {"maxD": maxD, "eps": 1e-10},
            # final-fit budget: the reference fits at maxD=L*MAX_D
            # (ttns2_ch3cn.py:37): keeps returned Ritz vectors orthonormal
            "stateFittingArgs": {"maxD": L * maxD, "eps": 1e-10},
            "linearSystemArgs": {"linearSolver": "minres", "method": "als",
                                 "nSweep": 2, "convTol": 1e-4,
                                 "siteTol": 1e-6, "linearIter": 120,
                                 "linear_tol": 1e-3,
                                 "maxD": maxD, "eps": 1e-10}}

    prev_tensors = xs[0]
    if seed_rung is not None:
        path = state_path(C.ART if seed_dir is None else seed_dir, seed_rung)
        if not os.path.exists(path):
            raise FileNotFoundError(f"--seed-rung {seed_rung}: no {path}")
        prev_tensors = C.load_tensors(path)
        print(f"seeding ladder from N={seed_rung} ({path})", flush=True)
    # resume: pick up the largest already-completed rung's state
    for N in sorted(done):
        if N in Ns and os.path.exists(state_path(out, N)):
            prev_tensors = C.load_tensors(state_path(out, N))
            print(f"resuming ladder from completed N={N}", flush=True)

    rungs = []
    for N in Ns:
        if N in done:
            print(f"N={N}: already done "
                  f"(zpve {done[N]['zpve_cm1']:.4f} cm-1), skipping",
                  flush=True)
            continue
        t1 = time.time()
        op_p, _, _ = ch3cn_operator(N=N, device=dev)
        mpo_p = MPO.from_sop_compressed(op_p)
        bonds = [int(t.shape[0]) for t in mpo_p.tensors]
        print(f"N={N} MPO bonds {bonds} [{time.time() - t1:.0f}s]",
              flush=True)

        Y0 = MPSVector(embed_mps(prev_tensors, N), opts,
                       device=dev).normalize()
        # state-follow the embedded rung guess by maximum overlap
        # (reference: ttns2_ch3cn.py:107-113), so the tracked state cannot
        # flip onto another root between rungs
        with C.Wall(dev) as w:
            ev, uv, status = inexactLanczosDiagonalization(
                mpo_p, Y0, sigma, L=L, maxit=maxit, eConv=1e-6,
                pick=get_pick_function_maxOvlp(Y0),
                writeOut=True, saveEachIteration=True,
                saveDir=os.path.join(out, f"ch3cn_ckpt_N{N}"),
                outFileName=os.path.join(out, f"iterations_ch3cn_N{N}.out"),
                summaryFileName=os.path.join(out, f"summary_ch3cn_N{N}.out"))
        e_au = float(np.real(find_nearest(ev, sigma)[1]))
        zpve = float(au2unit(e_au, "cm-1"))
        rec = {"N": N, "maxD": maxD, "L": L, "maxit": maxit,
               "zpve_cm1": round(zpve, 4),
               "err_vs_ref_cm1": round(zpve - C.REF_ZPVE_CM1, 4),
               "ref_cm1": C.REF_ZPVE_CM1,
               "converged": bool(status.get("isConverged")),
               "wall_s": round(w.s, 1),
               "mpo_bonds": bonds,
               "state_maxD": int(max(t.shape[0] for t in uv[0].tensors))}
        C.append_record(out, rec)
        print(f"N={N} targeted ZPVE: {zpve:.4f} cm-1 "
              f"(ref {C.REF_ZPVE_CM1}, err {zpve - C.REF_ZPVE_CM1:+.4f}) "
              f"converged={rec['converged']} [{w.s:.0f}s]", flush=True)

        prev_tensors = uv[0].tensors
        C.save_tensors(state_path(out, N), prev_tensors)
        rungs.append(dict(N=N, record=rec, ev=np.asarray(ev), status=status,
                          vector=uv[0], zpve_cm1=zpve, wall=w.s))
    return {"guess_cm1": guess_cm1, "rungs": rungs}


def main(argv=None):
    ap = C.parser(__doc__, out=True)
    ap.add_argument("Ns", nargs="*", type=int, default=[14, 28, 42])
    ap.add_argument("--seed-rung", type=int, default=None,
                    help="start from the committed rung state of this N")
    ap.add_argument("--seed-dir", default=None,
                    help="where --seed-rung's state is (default artifacts/)")
    args = ap.parse_args(argv)
    kw = {k: cast(os.environ.get(env, DEFAULTS[k]))
          for k, (env, cast) in ENV.items()}
    run(args.Ns or [14, 28, 42], device=C.device_arg(args), out=args.out,
        seed_rung=args.seed_rung, seed_dir=args.seed_dir, **kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
