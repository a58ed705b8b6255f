"""CH3CN flagship: the targeted nu8 excited pair on the production tree.

Block inexact Lanczos at sigma = zpve + 360 cm-1 on the 12-mode CH3CN
Hamiltonian, maxD 10, L 10, maxit 20, nBlock 2 (reference:
examples/ttns2_ch3cn_Block.py:24-31), as a ladder in N with exact
embedding between rungs:
  1. first rung: tree DMRG for the ground state and the 2 lowest excited
     states; the pair is the block guess, es[0] the zpve when no record
     gives one;
  2. block Lanczos with tree-ALS solves at the rung's sigma;
  3. next rung: both block states embed exactly into the larger basis.
The final-fit bond is L*maxD (the reference's bondAdaptFit budget).

Run:  python -m eigensolvers_tpu_torch.examples.ch3cn_excited_production
          [N ...] [--seed-rung N0] [--checkpoint] [--cpu] [--out DIR]
      (default 12 24 42)
Env:  CH3CN_MAXD (10), CH3CN_L (10), CH3CN_MAXIT (20), CH3CN_ECONV (1e-6),
      CH3CN_NBLOCK (2), CH3CN_NSWEEP (2: inner ALS sweeps per solve)
Outputs (under --out, default build/artifacts/): {"kind": "excited", ...}
lines in ch3cn_production.jsonl, the block states
ch3cn_tree_excited_N{N}_b{i}.npz, iterations_/summary_ch3cn_excited_N{N}.out
and, with --checkpoint, every iteration's Krylov basis through the native
writer in ch3cn_excited_ckpt_N{N}/.  The zpve of a rung comes from the
committed tree records (artifacts/ch3cn_production.jsonl), then from the
output's own; ``--seed-rung N0`` starts from the committed
artifacts/ch3cn_tree_excited_N{N0}_b{i}.npz (``--seed-dir`` for others).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from . import _common as C

DEFAULTS = dict(maxD=10, L=10, maxit=20, eConv=1e-6, nBlock=2, nSweep=2)
ENV = dict(maxD=("CH3CN_MAXD", int), L=("CH3CN_L", int),
           maxit=("CH3CN_MAXIT", int), eConv=("CH3CN_ECONV", float),
           nBlock=("CH3CN_NBLOCK", int), nSweep=("CH3CN_NSWEEP", int))
EPS = 1e-10


def state_path(d, N, i):
    return os.path.join(d, f"ch3cn_tree_excited_N{N}_b{i}.npz")


def options(maxD, L, nSweep):
    return {"compressArgs": {"maxD": maxD, "eps": EPS},
            # final-fit budget: the reference's bondAdaptFit maxD=L*MAX_D
            # (ttns2_ch3cn.py:37) keeps the returned Ritz vectors
            # orthonormal
            "stateFittingArgs": {"maxD": L * maxD, "eps": EPS},
            "linearSystemArgs": {"linearSolver": "minres", "method": "als",
                                 "nSweep": nSweep, "convTol": 1e-4,
                                 "siteTol": 1e-6, "linearIter": 120,
                                 "linear_tol": 1e-3,
                                 "maxD": maxD, "eps": EPS}}


def run(Ns=(12, 24, 42), maxD=10, L=10, maxit=20, eConv=1e-6, nBlock=2,
        nSweep=2, device=None, out=None, seed_rung=None, seed_dir=None,
        checkpoint=False, report=None):
    """The excited ladder over ``Ns``.  Returns {"rungs": [...]}, one dict
    per rung run: N, record, ev (a.u.), status, vectors (the block's Ritz
    states), op, topo, parts, sigma, zpve_cm1, wall, dmrg_cm1 and dmrg_s
    (the first rung's DMRG energies and time, else None)."""
    from .. import inexactLanczosDiagonalization
    from ..models.molecules import ch3cn_tree_operator
    from ..utils.units import au2unit, unit2au
    from ..vectors.ttns import TTNO, TTNSVector, ttns_embed_physical
    from ..vectors.ttns_sweeps import tree_dmrg_eigensolve

    dev = C.resolve_device(device)
    out = C.out_dir(out)
    recs = C.read_records(os.path.join(out, C.LOG_NAME))
    done = {int(d["N"]): d for d in recs if d.get("kind") == "excited"}
    opts = options(maxD, L, nSweep)
    if report is not None:
        opts["linearSystemArgs"]["report"] = report

    prev_states, prev_N = None, None
    if seed_rung is not None:
        d = C.ART if seed_dir is None else seed_dir
        paths = [state_path(d, seed_rung, i) for i in range(nBlock)]
        missing = [p for p in paths if not os.path.exists(p)]
        if missing:
            raise FileNotFoundError(f"--seed-rung {seed_rung}: no {missing}")
        prev_states = [C.load_tensors(p) for p in paths]
        prev_N = int(seed_rung)
        print(f"seeding excited ladder from N={prev_N} ({d})", flush=True)
    for N in sorted(done):
        if N in Ns and all(os.path.exists(state_path(out, N, i))
                           for i in range(nBlock)):
            prev_states = [C.load_tensors(state_path(out, N, i))
                           for i in range(nBlock)]
            prev_N = N
            print(f"resuming excited ladder from completed N={N}", flush=True)

    rungs = []
    for N in Ns:
        if N in done:
            d = done[N]
            print(f"excited N={N}: already done "
                  f"(excitations {d['excitation_cm1']} cm-1), skipping",
                  flush=True)
            continue
        if prev_N is not None and prev_N > N:
            raise ValueError(f"cannot embed the N={prev_N} states into "
                             f"N={N}: embedding goes from small to large")
        t1 = time.time()
        op, topo, parts, _ = ch3cn_tree_operator(N=N, device=dev)
        print(f"excited N={N} operator built [{time.time() - t1:.0f}s]",
              flush=True)
        zpve = C.rung_zpve_cm1(N, out)

        dmrg_cm1, dmrg_s = None, None
        if prev_states is None:
            # first rung: DMRG ground + 2 excited states (the nu8 pair)
            t0 = time.time()
            ttno = TTNO.from_sop_compressed(topo, op)
            op._ttno_cache = {(topo, None): ttno}   # the solver's own TTNO
            dims = [int(N ** len(p)) for p in parts]
            es, xs = tree_dmrg_eigensolve(topo, ttno.tensors, dims,
                                          nStates=nBlock + 1, maxD=maxD,
                                          nSweep=8, convTol=1e-9, seed=1)
            dmrg_cm1 = [float(au2unit(e, "cm-1")) for e in es]
            dmrg_s = time.time() - t0
            if zpve is None:
                zpve = dmrg_cm1[0]
            exc = [e - zpve for e in dmrg_cm1[1:]]
            print(f"DMRG N={N}: zpve {zpve:.4f} cm-1, excited guesses "
                  f"{np.round(exc, 2)} cm-1 [{time.time() - t0:.0f}s]",
                  flush=True)
            guess_tensors = xs[1:nBlock + 1]
        else:
            guess_tensors = [ttns_embed_physical(s, parts, prev_N, N,
                                                 device=dev)
                             for s in prev_states]
        if zpve is None:
            raise ValueError(f"no tree zpve record for N={N}; run "
                             f"ch3cn_tree_production first")

        # ladder seeds live at the KRYLOV bond: the stored fitted states
        # carry the L*maxD fit bond, and a matrix representation on a
        # bond-100 tree guess materializes (100*opBond)^3 intermediates;
        # compress first, the Krylov iteration runs at maxD anyway
        guesses = [TTNSVector(ts, opts, topo=topo, device=dev).normalize()
                   .compress() for ts in guess_tensors]
        if len(guesses) > 1:
            # embedding preserves orthogonality exactly, but the DMRG pair
            # is only orthogonal to its deflation tolerance: tidy it
            guesses = TTNSVector.orthogonalize(guesses)
            if len(guesses) != nBlock:
                raise RuntimeError("guess set collapsed")
        guesses = [g.normalize() for g in guesses]

        sigma = float(unit2au(zpve + C.TARGET_CM, "cm-1"))
        ckpt = {}
        if checkpoint:
            ckpt = dict(saveEachIteration=True,
                        saveDir=os.path.join(out, f"ch3cn_excited_ckpt_N{N}"))
        with C.Wall(dev) as w:
            ev, uv, status = inexactLanczosDiagonalization(
                op, guesses, sigma, L=L, maxit=maxit, eConv=eConv,
                checkFitTol=1e-4,
                eShift=float(unit2au(zpve, "cm-1")), convertUnit="cm-1",
                writeOut=True,
                outFileName=os.path.join(out,
                                         f"iterations_ch3cn_excited_N{N}.out"),
                summaryFileName=os.path.join(
                    out, f"summary_ch3cn_excited_N{N}.out"), **ckpt)
        wall = w.s

        evr = np.real(np.asarray(ev))
        order = np.argsort(np.abs(evr - sigma))[:nBlock]
        ev_b = np.sort(evr[order])
        ev_cm1 = [float(au2unit(e, "cm-1")) for e in ev_b]
        excitation = [round(e - zpve, 4) for e in ev_cm1]
        rec = {"kind": "excited", "topology": "tree", "N": N, "maxD": maxD,
               "L": L, "maxit": maxit, "eConv": eConv, "nBlock": nBlock,
               "target_cm1": C.TARGET_CM,
               "zpve_cm1": round(zpve, 4),
               "ev_cm1": [round(e, 4) for e in ev_cm1],
               "excitation_cm1": excitation,
               "converged": bool(status.get("isConverged")),
               "residual": float(status.get("residual", np.nan)),
               "cumIter": int(status.get("cumIter", -1)),
               "wall_s": round(wall, 1),
               "state_maxD": int(max(v.maxD for v in uv[:nBlock]))}
        C.append_record(out, rec)
        print(f"excited N={N}: excitations {excitation} cm-1 "
              f"(target {C.TARGET_CM}) converged={rec['converged']} "
              f"residual={rec['residual']:.2e} cumIter={rec['cumIter']} "
              f"[{wall:.0f}s]", flush=True)

        vectors = list(uv[:nBlock])
        prev_states = [v.tensors for v in vectors]
        prev_N = N
        for i, v in enumerate(vectors):
            C.save_tensors(state_path(out, N, i), v.tensors)
        rungs.append(dict(N=N, record=rec, ev=np.asarray(ev), status=status,
                          vectors=vectors, op=op, topo=topo, parts=parts,
                          sigma=sigma, zpve_cm1=zpve, wall=wall,
                          dmrg_cm1=dmrg_cm1, dmrg_s=dmrg_s))
    return {"rungs": rungs}


def main(argv=None):
    ap = C.parser(__doc__, out=True)
    ap.add_argument("Ns", nargs="*", type=int, default=[12, 24, 42])
    ap.add_argument("--seed-rung", type=int, default=None,
                    help="start from the committed rung states of this N")
    ap.add_argument("--seed-dir", default=None,
                    help="where --seed-rung's states are (default "
                         "artifacts/)")
    ap.add_argument("--checkpoint", action="store_true",
                    help="checkpoint every iteration (native writer)")
    args = ap.parse_args(argv)
    kw = {k: cast(os.environ.get(env, DEFAULTS[k]))
          for k, (env, cast) in ENV.items()}
    dev = C.device_arg(args)
    from ..vectors.mps import host_reads
    run(args.Ns or [12, 24, 42], device=dev, out=args.out,
        seed_rung=args.seed_rung, seed_dir=args.seed_dir,
        checkpoint=args.checkpoint, **kw)
    print(f"host reads {dict(host_reads)}" + C.peak_memory(dev), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
