"""Spans, counters, per-phase timers and traces.

The reference has only coarse wall-clock in the status dict
(SURVEY.md §5 "tracing/profiling: none").  Here:

* :class:`span` — a named region of the program.  Every span is also a
  counter: it adds one call and its host seconds to a process-wide
  registry (:func:`snapshot`).  While a ``torch.profiler`` records, it
  also enters ``record_function(name)``, so the region sits in the same
  trace as the device's kernels, on one clock.  Nothing switches it: it
  is traced exactly while a profiler records.  The port's names start
  with ``es.``;
* :func:`spans` — each pass of a loop in a span of its own;
  :func:`spanned` — each call of a function;
* :func:`to_host` — a blocking device-to-host read, counted as
  ``es.read``;
* :class:`PhaseTimer` — per-phase seconds and call counts for a driver's
  ``status["timers"]``, device-timed on a CUDA device (an event pair per
  phase, resolved once, at the end);
* :func:`trace` — context manager around ``torch.profiler`` producing a
  Chrome trace of host ops, the spans and the CUDA kernels.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled

# name -> [calls, host seconds]
_REGISTRY: Dict[str, list] = {}


def count(name: str, seconds: float = 0.0, calls: int = 1) -> None:
    """Add ``calls`` calls of ``name`` (one by default), and ``seconds``,
    to the registry."""
    c = _REGISTRY.get(name)
    if c is None:
        _REGISTRY[name] = [calls, seconds]
    else:
        c[0] += calls
        c[1] += seconds


def snapshot() -> Dict[str, dict]:
    """A copy of the registry: ``{name: {"calls", "seconds"}}``."""
    return {k: {"calls": c, "seconds": s} for k, (c, s) in _REGISTRY.items()}


def delta(before: Dict[str, dict], after: Optional[Dict[str, dict]] = None
          ) -> Dict[str, dict]:
    """What the registry gained from the snapshot ``before`` to ``after``
    (default: now); names that gained no call are left out."""
    after = snapshot() if after is None else after
    out = {}
    for k, v in after.items():
        b = before.get(k, {"calls": 0, "seconds": 0.0})
        if v["calls"] != b["calls"]:
            out[k] = {"calls": v["calls"] - b["calls"],
                      "seconds": v["seconds"] - b["seconds"]}
    return out


class span:
    """``with span("es.x"):`` counts one call of ``es.x`` and its host
    seconds (kept after the block as ``.seconds``), and puts the block in
    a ``record_function("es.x")`` range while a profiler records."""

    __slots__ = ("name", "seconds", "_t0", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = None
        if _profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        count(self.name, self.seconds)
        return False


def spans(name: str, iterable):
    """The items of ``iterable``, each pass of the loop over them in a span
    ``name`` of its own: ``for it in spans("es.x.outer", range(n)):``.  A
    pass's span closes when the loop asks for the next item, or when the
    loop is left (``break``, ``return`` or an exception drop the generator,
    which closes it at once)."""
    for item in iterable:
        with span(name):
            yield item


def spanned(name: str):
    """A decorator: each call of the function in a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host, in an ``es.read`` span: every blocking
    device-to-host read of the solve path goes through here, so that
    ``es.read`` counts them (a CPU tensor counts too, and is returned as
    it is)."""
    with span("es.read"):
        return t.cpu()


class PhaseTimer:
    """Seconds and calls per named phase of a driver; each phase is also
    the span ``<prefix>.<phase>``.  On a CUDA ``device`` a phase's seconds
    are the device's: a pair of events on the current stream at its
    edges, resolved by :meth:`summary` after one synchronize of the last
    event (nothing waits inside the loop).  Elsewhere they are the host's.

    >>> t = PhaseTimer("es.lanczos")
    >>> with t.phase("solve"):
    ...     pass
    >>> t.summary()   # {"solve": {"seconds": ..., "calls": 1}}
    """

    def __init__(self, prefix: str = "es", device=None):
        self.prefix = prefix
        self._stream = None
        if device is not None and torch.device(device).type == "cuda":
            self._stream = torch.cuda.current_stream(device)
        self._seconds: Dict[str, float] = defaultdict(float)
        self._calls: Dict[str, int] = defaultdict(int)
        self._events: Dict[str, list] = defaultdict(list)
        self._last = None

    def _event(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record(self._stream)
        return e

    @contextlib.contextmanager
    def phase(self, name: str):
        s = span(f"{self.prefix}.{name}")
        start = None
        try:
            with s:
                if self._stream is not None:
                    start = self._event()
                try:
                    yield
                finally:
                    if start is not None:
                        self._last = self._event()
                        self._events[name].append((start, self._last))
        finally:
            self._calls[name] += 1
            if start is None:
                self._seconds[name] += s.seconds

    def summary(self) -> Dict[str, dict]:
        if self._last is not None:
            self._last.synchronize()
            for name, pairs in self._events.items():
                self._seconds[name] += sum(a.elapsed_time(b)
                                           for a, b in pairs) / 1e3
            self._events.clear()
            self._last = None
        return {k: {"seconds": self._seconds[k], "calls": self._calls[k]}
                for k in self._calls}


@contextlib.contextmanager
def trace(logdir: Optional[str] = None, host_tracer_level: int = 2):
    """Host and device profiler trace, written as a Chrome trace
    (``{logdir}/trace.json``); the port's spans are in it.  Yields the
    ``torch.profiler.profile`` object (``key_averages()`` gives per-kernel
    sums), or None when ``logdir`` is None (no-op).
    ``host_tracer_level`` is the JAX package's argument, accepted and
    ignored: ``torch.profiler`` records host operators at one level."""
    if logdir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
