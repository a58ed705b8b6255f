#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on one NVIDIA GPU.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the comparison with the reference as the last lines on standard
error and one JSON object as the last line on standard output.  Exits
non-zero, with no result, without a card (3), when a module of JAX or of
the JAX package was loaded (4), or on any error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache at a fixed path inside the checkout
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    # one process with few threads: the host's numerical libraries run on
    # one thread each (set before numpy and torch load)
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import core, guards
    try:
        result, _ = core.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), T_START)
    except guards.NoDevice as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    found = guards.forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 4
    core.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
