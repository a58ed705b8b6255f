"""One run of one cell: set-up (the port, the cell's inputs, a warm-up of
the cell's own shapes), a closed-loop window of whole solves, the
comparison with the plain reference after the window, the result line.

Each solve starts from guesses drawn from (seed, solve index): the same
seed gives the same inputs.  The window runs whole solves until
``seconds`` have passed; the solve under way then finishes and counts.

Every solve's record holds the port's own counters' gain over it
(``counts``), and the run's record the counters after set-up; a traced
run (``trace``) also wraps the operator's applies in counting ``op.apply``
ranges, profiles the second solve whole, reduces that trace by
``op.apply`` ranges and by the port's ``es.*`` spans, and reports the
cell's per-layer metrics, each read from that record, instead of its
end-to-end ones.
"""

import collections
import contextlib
import gc
import json
import sys
import time
import warnings

import numpy as np
import torch

from . import guards, spans, spec
from .entries import counts, counts_since, merged, solve
from .judge import judge
from .tracing import ApplyCounter, profiler, reduce_profile, wrapper_shapes

WARMUP_INDEX = 2 ** 32 - 1      # the warm-up's guesses: no timed solve's
PROFILED = 1                    # the solve that the traced run profiles
GIB = 2 ** 30


def generator(seed, index, device):
    """A torch generator on ``device`` seeded from (seed, solve index)."""
    state = np.random.SeedSequence([int(seed) % 2 ** 64, index]) \
        .generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(state[0]) << 32) | int(state[1]))
    return gen


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


class Fault:
    """A fault planted in the timed path, for the tests that see
    ``correct`` come out false: ``wrap`` the program's operator,
    ``alter`` each solve's answer where it is produced."""

    def wrap(self, op):
        return op

    def alter(self, ev, V):
        return ev, V


class Cell:
    """One cell, set up: its inputs, the program's operator, the reference
    on demand, and whole solves from a seed's guesses.  ``device`` None:
    the card, required.  ``sizes`` replaces the configuration's sizes and
    ``traffic`` entries the mix's (the tests' small ones); ``control``
    switches on the program's own path of the precision below the
    configuration's (the configuration file's ``control`` entries);
    ``fault`` plants a :class:`Fault`."""

    def __init__(self, name, device=None, sizes=None, traffic=None,
                 control=False, fault=None):
        bench = self.bench = spec.benchmark()
        self.name = name
        self.entry = spec.cell(bench, name)
        if device is None:
            guards.require_cards(self.entry["chips"])
            device = torch.device("cuda", 0)
        self.device = device
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = spec.config_module(self.entry["config"])
        self.prog = spec.config_module(self.entry["config"], "_program")
        self.traffic = dict(spec.traffic(self.entry["traffic"]),
                            **(traffic or {}))
        self.limits = spec.limits(name)
        sizes = dict(sizes or spec.config_sizes(bench, self.entry["config"]))
        if control:
            sizes.update(sizes["control"]["sizes"])
        self.inp = self.cfg.inputs(sizes)
        self.tin = self.cfg.traffic_inputs(self.inp, self.traffic)
        self._ref = None
        self.fault = fault or Fault()
        self.op = self.fault.wrap(self.prog.operator(self.inp, device))
        self.counter = None

    @property
    def reference(self):
        if self._ref is None:
            self._ref = self.cfg.reference(self.inp, self.device)
        return self._ref

    def guesses(self, seed, index):
        """The guesses of solve ``index`` of a run with ``seed``, on the
        device in the state's type."""
        gen = generator(seed, index, self.device)
        return self.cfg.guesses(self.inp, self.traffic, gen,
                                self.device).to(self.inp.dtype)

    def warm_up(self, seed):
        """The cell's own shapes, in a shorter solve of the same entry from
        guesses of its own."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            solve(self.op, self.guesses(seed, WARMUP_INDEX), self.tin,
                  merged(self.traffic, self.traffic.get("warmup", {})), {})
        sync(self.device)

    def solve(self, seed, index, prof=None):
        """Solve ``index`` of a run with ``seed``, whole; its record
        (answers on the host)."""
        G = self.guesses(seed, index)
        report = {}
        if self.counter:
            self.counter.count = 0
            self.counter.shapes = [] if prof is not None else None
        before = counts()
        sync(self.device)
        with warnings.catch_warnings(record=True) as caught, \
                (prof if prof is not None else contextlib.nullcontext()):
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            ev, V, converged, status = solve(self.op, G, self.tin,
                                             self.traffic, report)
            sync(self.device)
            wall = time.perf_counter() - t0
        counted = counts_since(before)
        ev, V = self.fault.alter(ev, V)
        rec = {"wall_s": wall, "converged": converged,
               "ev": ev,
               "V": V.cpu(), "profiled": prof is not None,
               "warnings": [str(w.message)[:200] for w in caught],
               "counts": counted,
               "port_applies": self.prog.port_applies(
                   self.traffic["entry"], status, report)}
        if self.counter:
            rec["applies"] = self.counter.count
            rec["shapes"] = self.counter.shapes
        return rec

    def free_operator(self):
        if self.counter:
            self.counter.remove()
        self.op = self.counter = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self, solves):
        return judge(solves, self.reference, self.traffic["targets"],
                     self.tin, self.limits, self.device)


def describe(i, s):
    return (f"[solve {i}] wall {s['wall_s']:.4f} s, "
            f"converged "
            f"{s['converged']}, port's applies {s['port_applies']}"
            + (f", wrapper's applies {s['applies']}" if "applies" in s
               else "")
            + f", warnings {len(s['warnings'])}"
            + (f" ({s['warnings'][0]})" if s["warnings"] else "")
            + (" (profiled)" if s["profiled"] else ""))


def describe_counts(i, s):
    """The port's counts of one solve, beside the wrapper's where it
    counted."""
    c = s["counts"]

    def calls(name):
        return c.get(name, {}).get("calls", 0)
    wrapper = s.get("shapes") and wrapper_shapes(s["shapes"])
    return (f"[spans] solve {i}: applies {calls('es.apply')} (wrapper "
            f"{s.get('applies')}) by shape {spans.program_shapes(c)} "
            f"(wrapper {wrapper}), row by row {calls('es.apply.rowwise')}, "
            f"MINRES passes {calls('es.minres.pass')}, host reads "
            f"{calls('es.read')}, linear solves {calls('es.linear.solve')}"
            + (" (profiled)" if s["profiled"] else ""))


def run(cell_name, seed, seconds, trace, t_start, **kw):
    """Run ``cell_name`` once: (its result, the last line's object; its
    record, what the per-layer metrics read: ``solves``, the solves'
    records; ``setup_counts``, the port's counters after set-up;
    ``profile`` and ``spans``, the traced run's profiled solve reduced by
    ``op.apply`` ranges and by the port's spans, else None).  ``kw`` as
    :class:`Cell` takes them."""
    cell = Cell(cell_name, **kw)
    device = cell.device
    cell.warm_up(seed)
    setup_counts = counts()
    if trace:
        with profiler(device):          # the profiler's own first start
            torch.ones(8, device=device).sum()
        sync(device)
    setup_s = time.perf_counter() - t_start

    if trace:
        cell.counter = ApplyCounter(cell.op)
    solves, prof = [], None
    min_solves = PROFILED + 1 if trace else 1
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_window = time.perf_counter()
    while True:
        i = len(solves)
        p = profiler(device) if trace and i == PROFILED else None
        solves.append(cell.solve(seed, i, p))
        if p is not None:
            prof = p
        if time.perf_counter() - t_window >= seconds \
                and len(solves) >= min_solves:
            break
    window_s = time.perf_counter() - t_window
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    cell.free_operator()
    for i, s in enumerate(solves):
        log(describe(i, s))

    bench = cell.bench
    result = {"correct": False, "attempted": len(solves), "failed": 0,
              "metrics": {}, "device": _device(device, peak)}
    record = {"solves": solves, "setup_counts": setup_counts,
              "profile": None, "spans": None}
    if trace:
        for i, s in enumerate(solves):
            log(describe_counts(i, s))
        log("[spans] set-up " + json.dumps(
            {k: v for k, v in setup_counts.items()
             if k in ("es.parse", "es.build")}))
        if prof is not None:
            red = reduce_profile(prof)
            record["spans"] = spans.reduce_spans(prof)
            del prof
            ps = solves[PROFILED]
            bounds = {}
            for shape in ps["shapes"]:
                if shape not in bounds:
                    bounds[shape] = cell.cfg.apply_bound_s(cell.inp, *shape)
            red.update(wall_s=ps["wall_s"], applies=ps["applies"],
                       op_bound_s=sum(bounds[s] for s in ps["shapes"]))
            log(f"[trace] profiled solve {PROFILED}: wall "
                f"{red['wall_s']:.4f} s, device busy {red['busy_s']:.4f} s, "
                f"op.apply device {red['op_device_s']:.4f} s over "
                f"{red['applies']} applies {dict(collections.Counter(ps['shapes']))}, "
                f"bound {red['op_bound_s']:.4f} s; events {red['events']}")
            record["profile"] = red
            result["device"].update(busy_s=red["busy_s"],
                                    window_s=red["wall_s"])
            result["breakdown"] = {"device_ops": red["device_ops"],
                                   "idle_gaps": red["idle_gaps"]}
            log(spans.line(record["spans"], top=8))
            for path, sec in record["spans"]["paths"][:16]:
                log(f"[spans] path {sec:.6f} s  "
                    f"{' > '.join(path) or spans.NONE}")
        for m in spec.metrics_of(bench, cell_name, "per_layer"):
            value = spec.metric_reader(m["name"])(record)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        log("[per_layer] " + ", ".join(
            f"{k} {v['value']!r} {v['unit']}"
            for k, v in result["metrics"].items()))
    else:
        e2e = {"solve_s": sum(s["wall_s"] for s in solves) / len(solves),
               "peak_mem_gib": None if peak is None else peak / GIB,
               "setup_s": setup_s}
        for m in spec.metrics_of(bench, cell_name, "end_to_end"):
            if e2e.get(m["name"]) is not None:
                result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                                "unit": m["unit"]}
    log(f"[window] {len(solves)} solves in {window_s:.4f} s; set-up "
        f"{setup_s:.4f} s; peak {peak} bytes")

    numbers, failed, per = cell.judge(solves)
    for i, r in enumerate(per):
        log(f"[check {i}] " + ", ".join(f"{k} {v:.6g}" for k, v in r.items()))
    result["failed"] = failed
    result["correct"] = bool(solves) and failed == 0
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in numbers.items()}
    return result, record


def _device(device, peak):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak)}


def emit(result):
    """The checks as the last lines on stderr, then the result as the last
    line on stdout (its ``checks`` key last)."""
    for k, c in result["checks"].items():
        log(f"check {k}: {c['value']:.6g} (limit {c['limit']:.6g})")
    log(f"correct {result['correct']}: {result['attempted']} solves, "
        f"{result['failed']} failed")
    print(json.dumps(result), flush=True)
