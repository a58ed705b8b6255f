"""The comparison that decides ``correct``: every eigenpair that a timed
solve returned, against the plain reference, after the window.

Per solve, on the eigenpairs that the traffic's ``targets.pick`` names
(``picks/<pick>.py``: which returned values, held to which exact levels):

- ``ev_rel_err``: the largest |value - level| / |level|;
- ``residual``: the largest ||H v - value v|| / (||v|| ||H||) of the
  picked vectors, H applied by the reference in f64;
- ``rq_gap``: the largest |v.Hv / v.v - value| / |value|: each returned
  value against its vector's Rayleigh quotient under the reference's H;
- ``count_gap``, where the pick gives one: returned values that match no
  level of their own, plus levels that share a returned value;
- ``unconverged``: 1 if the solver did not report convergence within its
  ``maxit``.

Each cell's limits file names the numbers it compares (a number that the
control does not separate from the program's is read and printed, not
compared).  A run's number is the largest over its solves; a solve with
any compared number over its limit is failed.
"""

import numpy as np
import torch

from . import spec

NAMES = ("ev_rel_err", "residual", "rq_gap", "count_gap", "unconverged")


def readings(ev, V, converged, ref, levels, targets, tin, device):
    """The numbers of one solve (dict name -> value)."""
    ev = np.asarray(ev, dtype=np.float64)
    picks, want, gap = spec.pick(targets["pick"])(ev, levels, targets, tin)
    out = {"ev_rel_err": float(np.max(np.abs(ev[picks] - want)
                                      / np.abs(want))),
           "unconverged": 0 if converged else 1}
    if gap is not None:
        out["count_gap"] = gap
    P = V[picks].to(device=device, dtype=torch.float64)
    lam = torch.as_tensor(ev[picks], dtype=torch.float64, device=device)
    HP = ref.apply(P)
    norm = torch.linalg.vector_norm(P, dim=1)
    res = torch.linalg.vector_norm(HP - lam[:, None] * P, dim=1) / norm
    out["residual"] = float((res / ref.h_norm).max())
    rq = (P * HP).sum(dim=1) / norm ** 2
    out["rq_gap"] = float((torch.abs(rq - lam) / torch.abs(lam)).max())
    return out


def judge(solves, ref, targets, tin, limits, device):
    """(numbers: name -> (largest value, limit), failed solves, per-solve
    readings)."""
    levels = ref.levels()
    per = [readings(s["ev"], s["V"], s["converged"], ref, levels, targets,
                    tin, device) for s in solves]
    numbers = {k: (max(r[k] for r in per), limits[k])
               for k in NAMES if per and k in per[0] and k in limits}
    failed = sum(any(r[k] > limits[k] for k in r if k in limits)
                 for r in per)
    return numbers, failed, per
