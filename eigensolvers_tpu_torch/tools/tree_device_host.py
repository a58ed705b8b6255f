"""The tree algebra on the card against the CPU (ROADMAP A.10): one
``applyOp`` (apply, then compress to bond 10) and one ``tree_als_solve``
at the excited ladder's options, on the CH3CN tree at N = 12, from the
committed N = 12 excited state (artifacts/ch3cn_tree_excited_N12_b0.npz,
compressed to the Krylov bond), at sigma = the rung's zpve + 360 cm-1;
medians on the host clock with the device read counts of each call.

    python3 -m eigensolvers_tpu_torch.tools.tree_device_host

The CPU's tree_als_solve takes about a minute a call at this size."""

from __future__ import annotations

import os

import torch

from ..examples import _common as C
from ..examples.ch3cn_excited_production import options, state_path
from ..models.molecules import ch3cn_tree_operator
from ..utils.units import unit2au
from ..vectors.mps import host_reads, reset_host_reads
from ..vectors.ttns import TTNO, TTNSVector
from ..vectors.ttns_sweeps import tree_als_solve

N, MAXD, L = 12, 10, 10


def wall_ms(fn, reps, dev):
    import time
    times = []
    for _ in range(reps + 1):                      # the first warms up
        C.sync(dev)
        t0 = time.perf_counter()
        fn()
        C.sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times[1:])[reps // 2]


def measure(dev, reps=(5, 3)):
    op, topo, _, _ = ch3cn_tree_operator(N=N, device=dev)
    ttno = TTNO.from_sop_compressed(topo, op)
    opts = options(MAXD, L, 2)
    v = TTNSVector(C.load_tensors(state_path(C.ART, N, 0)), opts, topo=topo,
                   device=dev).normalize().compress()
    sigma = float(unit2au(C.rung_zpve_cm1(N, None) + C.TARGET_CM, "cm-1"))
    lin = opts["linearSystemArgs"]
    als = dict(sign=1.0, maxD=lin["maxD"], eps=lin["eps"],
               nSweep=lin["nSweep"], convTol=lin["convTol"],
               local_tol=lin["siteTol"], local_maxiter=lin["linearIter"])
    reset_host_reads()
    apply_ms = wall_ms(lambda: v.applyOp(ttno), reps[0], dev)
    per_apply = {k: n // (reps[0] + 1) for k, n in host_reads.items()}
    reset_host_reads()
    als_ms = wall_ms(lambda: tree_als_solve(topo, ttno.tensors, v.tensors,
                                            sigma, **als), reps[1], dev)
    per_solve = {k: n // (reps[1] + 1) for k, n in host_reads.items()}
    return (f"{torch.device(dev).type}: applyOp {apply_ms:.2f} ms "
            f"({per_apply}), tree_als_solve {als_ms:.1f} ms ({per_solve})")


def main():
    lines = [measure(C.resolve_device(None))]
    lines.append(measure("cpu", reps=(3, 1)))
    print(f"bond {MAXD}, N={N}, CPU threads {torch.get_num_threads()}: "
          + "; ".join(lines), flush=True)


if __name__ == "__main__":
    if not os.path.exists(state_path(C.ART, N, 0)):
        raise SystemExit("needs artifacts/ch3cn_tree_excited_N12_b0.npz")
    main()
