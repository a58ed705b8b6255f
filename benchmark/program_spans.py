#!/usr/bin/env python3
"""One run of a cell as ``run.py`` makes it, with the program's own spans
and counters read beside it:

    python3 benchmark/program_spans.py --workload <cell> --seed <n> \
        --seconds <s> --trace 1

The port's counters (``eigensolvers_tpu_torch/utils/profiling.py``) are
read at the end of set-up and diffed around every solve, and the profiled
solve's ``es.*`` ranges are reduced (``harness/spans.py``); ``harness/
core.py`` runs as it is, observed from outside.  Prints ``run.py``'s
result line, and on standard error, before the checks, ``[spans]`` lines:
the counts of every solve against the benchmark's apply wrapper, the
set-up's parse and build, the readings ``host_reads_per_solve``,
``loop_ms_per_pass`` and ``driver_share``, the spans with most device
time of their own, the idle by span and the device time by path.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def program_shapes(counts):
    """The port's ``es.apply.m<lanes>.<dtype>`` counts as
    {"<lanes>x<dtype>": applies}."""
    out = collections.Counter()
    for name, c in counts.items():
        p = name.split(".")
        if len(p) == 4 and p[:2] == ["es", "apply"] and p[2][:1] == "m":
            out[f"{p[2][1:]}x{p[3]}"] += c["calls"]
    return dict(out)


def wrapper_shapes(shapes):
    """The benchmark wrapper's (lanes, "f64" | "f32") list in the same
    form."""
    return dict(collections.Counter(
        f"{m}x{'float64' if d == 'f64' else 'float32'}" for m, d in shapes))


def readings(solves, red):
    """(host_reads_per_solve over the unprofiled solves, loop_ms_per_pass
    and driver_share from the profiled solve's reduction)."""
    from benchmark.harness.spans import device_s
    plain = [s["counts"].get("es.read", {}).get("calls", 0)
             for s in solves if not s["profiled"]]
    reads = sum(plain) / len(plain) if plain else None
    loop = share = None
    passes = red.get("spans", {}).get("es.minres.pass", {}).get("calls")
    if passes and red["device_s"]:
        loop = device_s(red, "es.minres.pass", ["es.apply"]) / passes * 1e3
        share = 100 * device_s(red, outside=["es.linear.solve"]) \
            / red["device_s"]
    return reads, loop, share


def main(argv=None, **kw):
    """``kw`` as ``core.run`` takes them (the tests' CPU and sizes)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import core, spans
    from eigensolvers_tpu_torch.utils import profiling

    solves, red, setup = [], {}, {}
    solve0, warm0 = core.Cell.solve, core.Cell.warm_up
    reduce0 = core.reduce_profile

    def solve(self, seed, index, prof=None):
        before = profiling.snapshot()
        rec = solve0(self, seed, index, prof)
        rec["counts"] = profiling.delta(before)
        solves.append(rec)
        return rec

    def warm_up(self, seed):
        warm0(self, seed)
        setup.update(profiling.snapshot())

    def reduce_profile(prof, *a, **k):
        red.update(spans.reduce_spans(prof))
        return reduce0(prof, *a, **k)

    core.Cell.solve, core.Cell.warm_up = solve, warm_up
    core.reduce_profile = reduce_profile
    try:
        result = core.run(args.workload, args.seed, args.seconds,
                          bool(args.trace), T_START, **kw)
    finally:
        core.Cell.solve, core.Cell.warm_up = solve0, warm0
        core.reduce_profile = reduce0
    log = core.log
    for i, s in enumerate(solves):
        c = s["counts"]
        wrapper = s.get("shapes") and wrapper_shapes(s["shapes"])
        log(f"[spans] solve {i}: applies {c.get('es.apply', {}).get('calls')}"
            f" (wrapper {s.get('applies')}) by shape {program_shapes(c)}"
            f" (wrapper {wrapper}), row by row "
            f"{c.get('es.apply.rowwise', {}).get('calls', 0)}, MINRES passes "
            f"{c.get('es.minres.pass', {}).get('calls')}, host reads "
            f"{c.get('es.read', {}).get('calls')}, linear solves "
            f"{c.get('es.linear.solve', {}).get('calls')}"
            + (" (profiled)" if s["profiled"] else ""))
    log("[spans] set-up " + json.dumps(
        {k: v for k, v in setup.items() if k in ("es.parse", "es.build")}))
    reads, loop, share = readings(solves, red)
    log(f"[spans] host_reads_per_solve {reads!r}, loop_ms_per_pass "
        f"{loop!r}, driver_share {share!r}")
    if red:
        log(spans.line(red, top=8))
        for p, sec in red["paths"][:16]:
            log(f"[spans] path {sec:.6f} s  {' > '.join(p) or '(none)'}")
    core.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
