"""Time versions of the multi-vector kernel B3 (``csrc/bsr_spmm.cu``)
against each other on a CUDA card, in one process, at the slice shape of
``chip_smoke.py`` ((2048, 9, 128, 128) blocks, n = 262,144).

    python3 -m eigensolvers_tpu_torch.tools.bench_spmm [--parent DIR]
        [--variant NAME=FILE ...] [--lanes 32,48,64,96,128] [--dtypes f32,f64]
        [--reps 30] [--ptxas] [--out FILE]

The versions are ``change`` (the package's own source), ``parent`` (the
same file under another checkout's root ``DIR``, for example a ``git
archive`` of the parent commit unpacked under ``build/``), and each
``--variant``: another source file of the same kernel, for example an
edited copy of ``csrc/bsr_spmm.cu`` with another tile, slab or
crossover.  All are built at once, one nvcc each.  Each version is first
held against the plain product ``bsr_matmat_plain`` (relative error 1e-5
in f32, 1e-12 in f64; a version that misses is not timed at that m, and
the run fails at the end); then, for each type and m (by default the
lane stacks of FEAST and spectrum slicing, 32 to 128), all versions are
timed in turns, forward and back (A B .. B A): median of ``--reps``
CUDA-event times per version and turn, the lower of its two medians
reported.  B1 (``bsr_spmv``), the single-vector kernel, is timed in the
same turns at m = 1.

Prints the card's name and power limit from ``nvidia-smi``, one line per
type and m (each version's time, share of the bound of :mod:`.yardstick`,
which ``chip_smoke.py`` reads too, and relative error), and ``--ptxas``'s
register and spill report of each version's kernels.  ``--out`` writes
the rows as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..models import product
from ..ops import kernels
from ..ops import sparse as bsr
from .yardstick import BANDWIDTH, PEAK_FLOPS, bound, slice_factors, time_ms

TOL = {"f32": 1e-5, "f64": 1e-12}
DTYPES = {"f32": torch.float32, "f64": torch.float64}


def load(src):
    """A version's library.  A source from before the row-block form has
    no ``ncb`` (block columns) in its entry points and takes the older
    argument list; ``lib.ncb`` says which."""
    if "int ncb" in Path(src).read_text():
        lib = kernels.load_bsr_spmm(src)
        lib.ncb = True
        return lib
    old = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib = kernels._load("bsr_spmm", {"bsr_spmm_f32": old,
                                     "bsr_spmm_f64": old}, src)
    lib.ncb = False
    return lib


def apply(lib, dataT, idx, X):
    """One square launch of a version's kernel on the lane stack X (m,
    npad)."""
    nrb, nbpr, B, _ = dataT.shape
    fn = lib.bsr_spmm_f32 if dataT.dtype == torch.float32 else lib.bsr_spmm_f64
    Y = torch.empty_like(X)
    dims = (nrb, nrb, nbpr, B) if lib.ncb else (nrb, nbpr, B)
    code = fn(dataT.data_ptr(), idx.data_ptr(), X.data_ptr(), Y.data_ptr(),
              *dims, X.shape[0], torch.cuda.current_stream().cuda_stream)
    kernels.check(lib, code, "bsr_spmm")
    return Y


def clocks(fn, seconds=1.0):
    """Median SM clock (MHz) and power draw (W) that ``nvidia-smi``
    samples every 20 ms while ``fn`` runs back to back for ``seconds``."""
    ms = time_ms(fn, 5)
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "20"],
        stdout=subprocess.PIPE, text=True)
    try:
        for _ in range(int(seconds * 1e3 / ms)):
            fn()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
    out = smi.communicate()[0]
    samples = np.array([[float(v) for v in line.split(",")]
                        for line in out.splitlines() if line.strip()])
    return [float(v) for v in np.median(samples[2:], axis=0)]


def bound_ms(dataT, idx, m, kind):
    """The bound of one product of m lanes, as ``chip_smoke.py`` has it."""
    size = dataT.element_size()
    return bound(dataT.numel() * size, idx.numel() * 4, m,
                 dataT.shape[0] * dataT.shape[2], size,
                 2 * dataT.numel() * m, PEAK_FLOPS[kind])[0]


def ptxas_report(src):
    """ptxas's register and spill lines for one source, built as the
    package builds it (``ops/kernels.py``) with ``-Xptxas -v``."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as d:
        proc = subprocess.run(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(Path(d) / "lib.so"), str(src)],
            capture_output=True, text=True, check=True)
    return [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
            if "registers" in line or "spill" in line
            or "Compiling entry" in line]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of another checkout whose "
                    "eigensolvers_tpu_torch/csrc/bsr_spmm.cu is timed too")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=FILE", help="another source file of the "
                    "kernel, timed as NAME")
    ap.add_argument("--lanes", default="32,48,64,96,128")
    ap.add_argument("--dtypes", default="f32,f64")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--ptxas", action="store_true",
                    help="print each version's registers and spills")
    ap.add_argument("--diag", action="store_true",
                    help="point every stored block at the block-diagonal "
                    "column (idx[r, t] = r): the same bytes and flops, with "
                    "the x gathers of a block-row all hitting one x block")
    ap.add_argument("--clocks", action="store_true",
                    help="also run each version for ~1 s per row while "
                    "nvidia-smi samples the SM clock and power draw")
    ap.add_argument("--out", help="write the rows as JSON to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_spmm: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)

    # (name, source file) of every version
    versions = {"change": kernels.CSRC / "bsr_spmm.cu"}
    if args.parent:
        versions["parent"] = (Path(args.parent) / "eigensolvers_tpu_torch"
                              / "csrc" / "bsr_spmm.cu")
    for v in args.variant:
        name, _, src = v.partition("=")
        versions[name] = Path(src)
    with ThreadPoolExecutor(len(versions)) as pool:
        libs = dict(zip(versions, pool.map(load, versions.values())))
        reports = pool.map(ptxas_report, versions.values()) \
            if args.ptxas else ()
        for name, lines in zip(versions, reports):
            for line in lines:
                print(f"[ptxas {name}] {line}")

    H_out, h_in = slice_factors()
    lanes = [int(m) for m in args.lanes.split(",")]
    rows, failed = [], []
    for kind in args.dtypes.split(","):
        op = product.kron_sum_bsr(H_out, h_in, BANDWIDTH, DTYPES[kind], dev)
        dataT, idx = op.dataT, op.idx
        if args.diag:
            idx = torch.arange(idx.shape[0], dtype=torch.int32, device=dev)[
                :, None].expand(idx.shape).contiguous()
        Xall = torch.as_tensor(np.random.RandomState(0).standard_normal(
            (max(lanes), op.n_padded)), dtype=DTYPES[kind], device=dev)
        for m in lanes:
            X = Xall[:m].contiguous()
            ref = bsr.bsr_matmat_plain(dataT, idx, X)
            fns = {n: (lambda lib=lib: apply(lib, dataT, idx, X))
                   for n, lib in libs.items()}
            errs = {}
            for name, fn in list(fns.items()):
                y = fn()
                errs[name] = err = float((y.double() - ref.double()).abs()
                                         .max() / ref.double().abs().max())
                if not err <= TOL[kind]:      # not timed; the run fails
                    failed.append(f"{name} {kind} m={m} rel err {err:.3e} > "
                                  f"{TOL[kind]:.0e}")
                    print(f"[{kind} m={m}] {failed[-1]}", flush=True)
                    del fns[name]
            del ref, y
            if m == 1:
                fns["B1 bsr_spmv"] = lambda: bsr.bsr_matvec(dataT, idx, X[0])
            order = list(fns) + list(fns)[::-1]
            times = {n: [] for n in fns}
            for name in order:
                times[name].append(time_ms(fns[name], args.reps))
            bnd = bound_ms(dataT, idx, m, kind)
            row = dict(card=card, dtype=kind, m=m, bound_ms=bnd,
                       ms={n: min(t) for n, t in times.items()},
                       turns=times, rel_err=errs)
            if args.clocks:
                row["clocks"] = {n: clocks(fn) for n, fn in fns.items()}
                print(f"[{kind} m={m}] median SM MHz, W under load: " + "; ".join(
                    f"{n} {c[0]:.0f}, {c[1]:.0f}" for n, c in
                    row["clocks"].items()), flush=True)
            rows.append(row)
            print(f"[{kind} m={m}] bound {bnd:.4f} ms; " + "; ".join(
                f"{n} {min(t):.4f} ms ({bnd / min(t):.0%}; "
                f"{t[0]:.4f}/{t[1]:.4f}; rel err {errs.get(n, 0):.1e})"
                for n, t in times.items()), flush=True)
        del op, dataT, idx, Xall
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    if failed:
        raise SystemExit("bench_spmm: " + "; ".join(failed))


if __name__ == "__main__":
    main()
