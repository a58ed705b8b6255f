"""ch3cn6: the system under test's operator, built by the port from the
configuration's copy of the ``.op`` file (the port's parser, bases and
grouped sum-of-products operator, as ``models/molecules.ch3cn_operator``
builds it), and the port's own count of its applies."""

import numpy as np


def operator(inp, device):
    from eigensolvers_tpu_torch.models.bases import Hermite
    from eigensolvers_tpu_torch.models.op_parser import (build_sop_operator,
                                                         parse_op_file)
    s = inp.sizes
    spec = parse_op_file(str(inp.op_file))
    spec.terms = [t for t in spec.terms
                  if all(d < s["nModes"] for d in t.factors)]
    spec.mode_labels = spec.mode_labels[:s["nModes"]]
    bases = [Hermite(Hermite.getOptions(N=s["N"],
                                        representation=s["representation"]))
             for _ in range(s["nModes"])]
    return build_sop_operator(spec, bases, dtype=getattr(np, s["dtype"]),
                              fuse=s["fuse"], device=device)


def port_applies(entry, status, report):
    """The port's own count of operator applies in a solve, from the
    ``linearSystemArgs["report"]`` counts and the solver's status: the
    solves' applies, one per extend of H, one for the guesses' H and one
    per restart (general Lanczos)."""
    solves = report.get("matvecs", 0) + report.get("matmats", 0)
    if entry != "lanczos":
        return solves
    extends = status["timers"].get("extend_subspace", {}).get("calls", 0)
    return solves + extends + 1 + status["restarts"]
