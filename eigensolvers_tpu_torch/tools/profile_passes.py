"""Cost of one MINRES pass on a CUDA card: the single-vector solve
(``minres``, one SpMV per pass through B1/B2) against the lane stack
(``minres_batch``, one multi-vector apply per pass through B3), on the
n = 262,144 two-mode operator that ``chip_smoke.py`` solves.

    python3 -m eigensolvers_tpu_torch.tools.profile_passes [--iters 400]

Each solve is Jacobi-preconditioned, at the shift ``chip_smoke.py`` uses,
with ``rtol=0`` so that it runs exactly ``--iters`` iterations.  For each
precision ("highest", "high") and form (single; lanes with m = 1, 2) it
prints one JSON line:

* ``wall_ms_per_pass``: host clock around the solve, ending in a
  synchronize, median of 3 runs without the profiler, over the passes the
  kernel counters saw;
* ``device_ms_per_pass``, ``kernels_per_pass``: summed self device time and
  count of the CUDA kernels ``torch.profiler`` records in a fourth run;
* ``busy``: device over wall, the share of the pass the card is working;
* ``spmv_ms_per_pass``, ``spmv_share``: the same for the BSR kernel alone;
* ``top``: the four kernels with the most device time, in µs per pass.

The first line is the card's name and power limit from ``nvidia-smi``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..models import product
from ..ops import sparse as bsr
from ..ops.linear_solvers import minres, minres_batch

# the operator and shift of chip_smoke.py
M_OUT, B_IN, BANDWIDTH = 2048, 128, 4
OMEGA_OUT, LAM, OMEGA_IN, X_RANGE = 1.0, 1e-3, 1.3, (-7.0, 7.0)
TARGET_LEVEL = 20


def _device_events(prof):
    """(name, self device µs, count) of each CUDA kernel in the profile."""
    out = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        out.append((e.key, float(us), int(e.count)))
    return out


def profile(solve, reps=3):
    """Wall per pass (median of ``reps``), then one profiled run."""
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        bsr.reset_launch_counts()
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    passes = sum(bsr.launches.values())
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        solve()
        torch.cuda.synchronize()
    events = _device_events(prof)
    device_us = sum(us for _, us, _ in events)
    spmv_us = sum(us for name, us, _ in events if "bsr_sp" in name)
    wall_ms = float(np.median(walls)) / passes * 1e3
    top = sorted(events, key=lambda e: -e[1])[:4]
    return {
        "passes": passes,
        "wall_ms_per_pass": wall_ms,
        "device_ms_per_pass": device_us / passes / 1e3,
        "kernels_per_pass": sum(c for _, _, c in events) / passes,
        "busy": device_us / passes / 1e3 / wall_ms,
        "spmv_ms_per_pass": spmv_us / passes / 1e3,
        "spmv_share": spmv_us / passes / 1e3 / wall_ms,
        "top": [[name[:48], us / passes] for name, us, _ in top],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=400)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_passes: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)

    H_out = product.anharmonic_oscillator_fbr(M_OUT, OMEGA_OUT, LAM)
    h_in = product.sinc_dvr_oscillator(B_IN, OMEGA_IN, X_RANGE)
    levels = product.kron_sum_levels(np.linalg.eigvalsh(H_out),
                                     np.linalg.eigvalsh(h_in),
                                     TARGET_LEVEL + 2)
    sigma = float(levels[TARGET_LEVEL]
                  + 0.2 * (levels[TARGET_LEVEL + 1] - levels[TARGET_LEVEL]))
    op32 = product.kron_sum_bsr(H_out, h_in, BANDWIDTH, torch.float32, dev)
    b = torch.as_tensor(np.random.RandomState(0).standard_normal(
        (2, op32.n)), dtype=torch.float32, device=dev)
    kw = dict(rtol=0.0, maxiter=args.iters, precond="jacobi")
    for prec in ("highest", "high"):
        op = bsr.BSROperator.from_transposed(op32.dataT, op32.idx, op32.n,
                                             precision=prec)
        forms = [("single", lambda: minres(op, b[0], sigma, **kw))]
        for m in (1, 2):
            forms.append((f"lanes m={m}", lambda m=m: minres_batch(
                op, b[:m], [sigma] * m, **kw)))
        for name, solve in forms:
            solve()                                  # build and warm up
            print(f"{prec} {name} {json.dumps(profile(solve))}", flush=True)


if __name__ == "__main__":
    main()
