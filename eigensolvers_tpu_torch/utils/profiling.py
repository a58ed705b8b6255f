"""Tracing and structured per-phase timing.

The reference has only coarse wall-clock in the status dict
(SURVEY.md §5 "tracing/profiling: none").  Here:

* :class:`PhaseTimer` — a structured metrics accumulator (per-phase wall
  time, call counts) that solvers and drivers can thread through the status
  dict;
* :func:`trace` — context manager around ``torch.profiler`` producing a
  Chrome trace of host ops and CUDA kernels.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional


class PhaseTimer:
    """Accumulates wall-clock per named phase.

    >>> t = PhaseTimer()
    >>> with t.phase("solve"):
    ...     pass
    >>> t.summary()   # {"solve": {"seconds": ..., "calls": 1}}
    """

    def __init__(self):
        self._seconds: Dict[str, float] = defaultdict(float)
        self._calls: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._seconds[name] += time.perf_counter() - t0
            self._calls[name] += 1

    def add(self, name: str, seconds: float):
        self._seconds[name] += seconds
        self._calls[name] += 1

    def summary(self) -> Dict[str, dict]:
        return {k: {"seconds": self._seconds[k], "calls": self._calls[k]}
                for k in self._seconds}

    def report(self) -> str:
        lines = [f"{'phase':<24}{'seconds':>12}{'calls':>8}"]
        for k in sorted(self._seconds, key=self._seconds.get, reverse=True):
            lines.append(f"{k:<24}{self._seconds[k]:>12.3f}{self._calls[k]:>8}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: Optional[str] = None, host_tracer_level: int = 2):
    """Host and device profiler trace, written as a Chrome trace
    (``{logdir}/trace.json``).  Yields the ``torch.profiler.profile``
    object (``key_averages()`` gives per-kernel sums), or None when
    ``logdir`` is None (no-op).  ``host_tracer_level`` is the JAX
    package's argument, accepted and ignored: ``torch.profiler`` records
    host operators at one level."""
    if logdir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
