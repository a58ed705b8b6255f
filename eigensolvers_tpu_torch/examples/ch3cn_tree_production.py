"""CH3CN zero-point energy on the reference's production TREE topology:
targeted inexact Lanczos with tree-ALS inner sweeps at N per mode on the
15-node tree with fused 2-mode leaves (reference:
examples/ttns2_ch3cn_Block.py:62-76; production zpve 9837.4069 cm-1 at
N=42, maxD=10, examples/ttns2_ch3cn.py:25-34).

Ladder: a coarse tree-DMRG guess at N = 6, then targeted Lanczos rungs at
increasing N with exact state embedding between rungs (HO-basis identity:
each physical index zero-pads; fused leaves embed through the
(i, j) -> i*N + j product index, not a flat pad).  Its records give the
excited ladder (``ch3cn_excited_production``) its rung zpves.

Run:  python -m eigensolvers_tpu_torch.examples.ch3cn_tree_production
          [N ...] [--seed-rung N0] [--cpu] [--out DIR]  (default 12 24 42)
Env:  CH3CN_MAXD (10), CH3CN_MAXIT (2), CH3CN_L (4); CH3CN_DEPTH_CONFIRM=1
      re-runs completed rungs at the current L/maxit from their own states
Outputs (under --out, default build/artifacts/): records with
"topology": "tree" in ch3cn_production.jsonl, the rung states
ch3cn_tree_state_N{N}.npz, iterations_/summary_ch3cn_tree_N{N}.out.
``--seed-rung N0`` starts from the committed
artifacts/ch3cn_tree_state_N{N0}.npz (``--seed-dir`` for others).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from . import _common as C

DEFAULTS = dict(maxD=10, maxit=2, L=4)
ENV = dict(maxD=("CH3CN_MAXD", int), maxit=("CH3CN_MAXIT", int),
           L=("CH3CN_L", int))
N_GUESS = 6


def state_path(d, N):
    return os.path.join(d, f"ch3cn_tree_state_N{N}.npz")


def embed_tree(tensors, parts, n_old, n_new, device=None):
    """Exact TTNS embedding between HO basis sizes
    (:func:`~eigensolvers_tpu_torch.vectors.ttns.ttns_embed_physical`)."""
    from ..vectors.ttns import ttns_embed_physical
    return ttns_embed_physical(tensors, parts, n_old, n_new, device=device)


def done_rungs(out):
    return {int(d["N"]): d
            for d in C.read_records(os.path.join(out, C.LOG_NAME))
            if d.get("topology") == "tree" and d.get("kind") is None
            and not d.get("depth_confirm")}


def run(Ns=(12, 24, 42), maxD=10, maxit=2, L=4, depth_confirm=False,
        device=None, out=None, seed_rung=None, seed_dir=None):
    """The tree ZPVE ladder over ``Ns``.  Returns {"guess_cm1", "rungs":
    [{N, record, ev, status, vector, zpve_cm1, wall}]}."""
    from .. import find_nearest, inexactLanczosDiagonalization
    from ..models.molecules import ch3cn_tree_operator
    from ..utils.units import au2unit
    from ..vectors.ttns import TTNO, TTNSVector
    from ..vectors.ttns_sweeps import tree_dmrg_eigensolve

    dev = C.resolve_device(device)
    out = C.out_dir(out)
    done = done_rungs(out)

    # coarse-basis tree-DMRG guess (small N cannot reach the PES turnover,
    # so the global search is safe)
    t0 = time.time()
    op_g, topo, parts, _ = ch3cn_tree_operator(N=N_GUESS, device=dev)
    ttno_g = TTNO.from_sop_compressed(topo, op_g)
    dims_g = [int(N_GUESS ** len(p)) for p in parts]
    es, xs = tree_dmrg_eigensolve(topo, ttno_g.tensors, dims_g, nStates=1,
                                  maxD=8, nSweep=6, convTol=1e-9, seed=1)
    sigma = float(es[0])
    guess_cm1 = float(au2unit(sigma, "cm-1"))
    print(f"guess (tree N={N_GUESS} DMRG): {guess_cm1:.4f} cm-1 "
          f"[{time.time() - t0:.0f}s]", flush=True)

    opts = {"compressArgs": {"maxD": maxD, "eps": 1e-10},
            # final-fit budget: the reference fits at maxD=L*MAX_D
            # (ttns2_ch3cn.py:37)
            "stateFittingArgs": {"maxD": L * maxD, "eps": 1e-10},
            "linearSystemArgs": {"linearSolver": "minres", "method": "als",
                                 "nSweep": 2, "convTol": 1e-4,
                                 "siteTol": 1e-6, "linearIter": 120,
                                 "linear_tol": 1e-3,
                                 "maxD": maxD, "eps": 1e-10}}

    prev_tensors, prev_N = xs[0], N_GUESS
    if seed_rung is not None:
        path = state_path(C.ART if seed_dir is None else seed_dir, seed_rung)
        if not os.path.exists(path):
            raise FileNotFoundError(f"--seed-rung {seed_rung}: no {path}")
        prev_tensors, prev_N = C.load_tensors(path), int(seed_rung)
        print(f"seeding tree ladder from N={prev_N} ({path})", flush=True)
    for N in sorted(done):
        if N in Ns and os.path.exists(state_path(out, N)):
            prev_tensors = C.load_tensors(state_path(out, N))
            prev_N = N
            print(f"resuming tree ladder from completed N={N}", flush=True)

    rungs = []
    for N in Ns:
        if N in done and not depth_confirm:
            print(f"tree N={N}: already done "
                  f"(zpve {done[N]['zpve_cm1']:.4f} cm-1), skipping",
                  flush=True)
            continue
        if depth_confirm and N in done and os.path.exists(state_path(out, N)):
            # re-converge this rung AT ITS OWN BASIS from its own state
            guess_tensors = C.load_tensors(state_path(out, N))
        elif prev_N > N:
            # the JAX driver pads by a negative width here and crashes
            need = (f"its own state {state_path(out, N)} is missing and "
                    if depth_confirm and N in done else "")
            raise ValueError(
                f"tree N={N}: {need}the ladder's state is at N={prev_N} > "
                f"{N}; embedding only goes from a smaller basis to a "
                f"larger one")
        else:
            guess_tensors = None
        t1 = time.time()
        op_p, topo_p, parts_p, _ = ch3cn_tree_operator(N=N, device=dev)
        print(f"tree N={N} operator built [{time.time() - t1:.0f}s]",
              flush=True)
        if guess_tensors is None:
            guess_tensors = embed_tree(prev_tensors, parts, prev_N, N,
                                       device=dev)
        Y0 = TTNSVector(guess_tensors, opts, topo=topo_p,
                        device=dev).normalize()
        with C.Wall(dev) as w:
            ev, uv, status = inexactLanczosDiagonalization(
                op_p, Y0, sigma, L=L, maxit=maxit, eConv=1e-6,
                writeOut=True,
                outFileName=os.path.join(out,
                                         f"iterations_ch3cn_tree_N{N}.out"),
                summaryFileName=os.path.join(out,
                                             f"summary_ch3cn_tree_N{N}.out"))
        e_au = float(np.real(find_nearest(ev, sigma)[1]))
        zpve = float(au2unit(e_au, "cm-1"))
        rec = {"N": N, "topology": "tree", "maxD": maxD, "L": L,
               "maxit": maxit,
               **({"depth_confirm": True} if depth_confirm else {}),
               "zpve_cm1": round(zpve, 4),
               "err_vs_ref_cm1": round(zpve - C.REF_ZPVE_CM1, 4),
               "ref_cm1": C.REF_ZPVE_CM1,
               "converged": bool(status.get("isConverged")),
               "wall_s": round(w.s, 1),
               "state_maxD": int(max(t.shape[0] for t in uv[0].tensors))}
        C.append_record(out, rec)
        print(f"tree N={N} targeted ZPVE: {zpve:.4f} cm-1 "
              f"(ref {C.REF_ZPVE_CM1}, err {zpve - C.REF_ZPVE_CM1:+.4f}) "
              f"converged={rec['converged']} [{w.s:.0f}s]", flush=True)

        prev_tensors, prev_N = uv[0].tensors, N
        C.save_tensors(state_path(out, N), prev_tensors)
        rungs.append(dict(N=N, record=rec, ev=np.asarray(ev), status=status,
                          vector=uv[0], zpve_cm1=zpve, wall=w.s))
    return {"guess_cm1": guess_cm1, "rungs": rungs}


def main(argv=None):
    ap = C.parser(__doc__, out=True)
    ap.add_argument("Ns", nargs="*", type=int, default=[12, 24, 42])
    ap.add_argument("--seed-rung", type=int, default=None,
                    help="start from the committed rung state of this N")
    ap.add_argument("--seed-dir", default=None,
                    help="where --seed-rung's state is (default artifacts/)")
    args = ap.parse_args(argv)
    kw = {k: cast(os.environ.get(env, DEFAULTS[k]))
          for k, (env, cast) in ENV.items()}
    run(args.Ns or [12, 24, 42],
        depth_confirm=os.environ.get("CH3CN_DEPTH_CONFIRM") == "1",
        device=C.device_arg(args), out=args.out, seed_rung=args.seed_rung,
        seed_dir=args.seed_dir, **kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
