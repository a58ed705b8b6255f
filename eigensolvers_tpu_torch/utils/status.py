"""Status dictionaries — the metrics bus of both eigensolvers.

The status dict doubles as input config (overwrite-defaults merge) and output
telemetry, and is returned to the caller / asserted on in tests
(reference: inexact_Lanczos.py:23-82, feast.py:16-43; SURVEY.md §5).
"""

from __future__ import annotations

import time

import numpy as np


def lanczos_status(status, guessVector, nBlock) -> dict:
    """Initialize/merge the Lanczos status dict
    (keys per reference inexact_Lanczos.py:65-73).

    "ref" holds at most two arrays of the nBlock tracked eigenvalues: the last
    entry is the residual reference for convergence, the first the reference
    for futile-restart detection.  "zeroVector" flags a linear solution with
    norm below 0.001*eConv.
    """
    out = {
        "ref": [], "residual": np.inf, "nBlock": nBlock,
        "flagAddition": guessVector.hasExactAddition,
        "outerIter": 0, "innerIter": 0, "cumIter": 0,
        "iBlock": 0, "zeroVector": False,
        "isConverged": False, "lindep": False,
        "futileRestarts": 0, "restarts": 0,
        "startTime": time.time(), "runTime": 0.0,
        "KSmaxD": [], "fitmaxD": None,
        "phase": 1,
    }
    if status is not None:
        out.update(status)
    return out


def feast_status(status, guess) -> dict:
    """Initialize/merge the FEAST status dict (reference: feast.py:16-43)."""
    out = {
        "flagAddition": guess[0].hasExactAddition,
        "outerIter": 0, "quadrature": 0,
        "isConverged": False,
        "phase": 1,
        "residual": None,
        "lindep": False,
        "startTime": time.time(), "runTime": 0.0,
    }
    if status is not None:
        out.update(status)
    return out
