"""Time versions of the block-ELL kernels against each other on a CUDA
card, in one process, at the slice shape of ``chip_smoke.py`` ((2048, 9,
128, 128) blocks, n = 262,144): B3 (``csrc/bsr_spmm.cu``, the default),
its bf16x3 form (``--kernel split``, ``csrc/bsr_spmm_split.cu``) or the
single-vector apply B1 (``--kernel b1``: B3's kernel with one vector).

    python3 -m eigensolvers_tpu_torch.tools.bench_spmm [--kernel b3|split|b1]
        [--parent DIR] [--variant NAME=FILE ...] [--lanes 32,48,64,96,128]
        [--dtypes f32,f64] [--reps 30] [--ptxas] [--out FILE]

The versions are ``change`` (the package's own source), ``parent`` (the
same file under another checkout's root ``DIR``, for example a ``git
archive`` of the parent commit unpacked under ``build/``), and each
``--variant``: another source file of the same kernel, for example an
edited copy with another tile, slab or crossover.  All are built at once,
one nvcc each.  Each version is first held to its oracle at each m (a
version that misses is not timed at that m, and the run fails at the end):
B3 to the plain product ``bsr_matmat_plain`` (relative error 1e-5 in f32,
1e-12 in f64); the split kernel, as ``chip_smoke.py`` holds it, to the
exact split product (the same bf16 products summed in f64: 2e-6 of max |y|
at the slice) and by its signature (|t| <= 0.1, the share of the split's
own error it carries; a true-f32 product reads 1).  Then, for each type and
m (B3: by default the lane stacks of FEAST and spectrum slicing, 32 to 128;
split: 1, 2, 8, 16, 32, 48, 64, 96, 128, f32 only), all versions are timed
in turns, forward and back (A B .. B A): median of ``--reps`` CUDA-event
times per version and turn, the lower of its two medians reported.  In the
same turns: the package's B3 at "highest" on the same f32 blocks beside the
split kernel (the exact form a user trades "high" against).

``--kernel b1`` times the single-vector apply's versions, f32 and f64, at
two shapes: the square launch and a row block (block rows [0, 512) of 2048
with the whole x: a rank's launch in a 4-way row split).  A version is a
B3 source launched with one lane, or a source of the separate single-vector
kernel that the package had before (``bsr_spmv_f32``/``_f64``, for example
``--parent`` on a checkout that has ``csrc/bsr_spmv.cu``; the parent's
``bsr_spmm.cu`` where it has none).  Each version is held to
``bsr_matvec_plain`` (1e-5 in f32, 1e-12 in f64), compared bit for bit with
"change", and its row block with its own square rows.  In the same turns:
the package's wrapper (``bsr_matvec``, the change with its host checks),
the library call (``A @ x``, A a ``torch.sparse_bsr_tensor`` of the same
blocks), and "read", one ``sum`` over the same blocks: how fast a plain
streaming read of those bytes runs on the card.  After the turns, each
one's device time from torch.profiler, so that the event time splits into
the kernel's own time and the launch gap, and the host time of one call
(the Python and the launch call, which the gap holds).

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
from .yardstick import (BANDWIDTH, PEAK_FLOPS, SIGNATURE_TOL, bound,
                        device_ms, host_us, signature, slice_factors,
                        sparse_bsr, split_tol, time_ms)

TOL = {"f32": 1e-5, "f64": 1e-12}
DTYPES = {"f32": torch.float32, "f64": torch.float64}
SOURCES = {"b3": "bsr_spmm.cu", "split": "bsr_spmm_split.cu",
           "b1": "bsr_spmm.cu"}
# the separate single-vector kernel's file, before B1 went to B3's kernel
OLD_B1 = "bsr_spmv.cu"
LANES = {"b3": "32,48,64,96,128", "split": "1,2,8,16,32,48,64,96,128"}
# B1's row block: the first of 4 ranges of block rows, with the whole x
ROW_RANGES = 4


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


def load_split(src):
    """A version of the split kernel's library (every version since the
    row-block form takes ``ncb``)."""
    return kernels.load_bsr_spmm_split(src)


def apply_split(lib, hi, lo, idx, X):
    """One square launch of a split kernel version on the lane stack X."""
    nrb, nbpr, B, _ = hi.shape
    Y = torch.empty_like(X)
    code = kernels.launch(lib.bsr_spmm_split_f32, X.device, hi.data_ptr(),
                       lo.data_ptr(), idx.data_ptr(), X.data_ptr(),
                       Y.data_ptr(), nrb, nrb, nbpr, B, X.shape[0])
    kernels.check(lib, code, "bsr_spmm_split")
    return Y


def load_b1(src):
    """A single-vector version's library: the old separate kernel where the
    source has its entry points (``lib.b1``), else a B3 source."""
    if "bsr_spmv_f32" not in Path(src).read_text():
        lib = load(src)
        lib.b1 = False
        return lib
    one = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib = kernels._load("bsr_spmv", {"bsr_spmv_f32": one,
                                     "bsr_spmv_f64": one}, src)
    lib.b1 = True
    return lib


def apply_b1(lib, dataT, idx, x):
    """One launch of a single-vector version on x (ncb*B,): the square
    operator, or a row block of fewer block rows."""
    nrb, nbpr, B, _ = dataT.shape
    f32 = dataT.dtype == torch.float32
    y = x.new_empty(nrb * B)
    if lib.b1:
        fn = lib.bsr_spmv_f32 if f32 else lib.bsr_spmv_f64
        dims = (nrb, nbpr, B)
    else:
        if not lib.ncb:
            raise SystemExit("bench_spmm: a B3 source without ncb takes no "
                             "row block")
        fn = lib.bsr_spmm_f32 if f32 else lib.bsr_spmm_f64
        dims = (nrb, x.numel() // B, nbpr, B, 1)
    code = kernels.launch(fn, x.device, dataT.data_ptr(), idx.data_ptr(),
                       x.data_ptr(), y.data_ptr(), *dims)
    kernels.check(lib, code, "single-vector")
    return y


def apply(lib, dataT, idx, X):
    """One square launch of a version's kernel on the lane stack X (m,
    npad)."""
    nrb, nbpr, B, _ = dataT.shape
    fn = lib.bsr_spmm_f32 if dataT.dtype == torch.float32 else lib.bsr_spmm_f64
    Y = torch.empty_like(X)
    dims = (nrb, nrb, nbpr, B) if lib.ncb else (nrb, nbpr, B)
    code = kernels.launch(fn, X.device, dataT.data_ptr(), idx.data_ptr(),
                       X.data_ptr(), Y.data_ptr(), *dims, X.shape[0])
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


def bound_ms(dataT, idx, m, kind, ncols=None):
    """The bound of one product of m lanes, as ``chip_smoke.py`` has it:
    the split form moves the f32 bytes (hi + lo) and does 6 bf16 flops per
    element and lane.  ``ncols``: the length of x for a row block (default:
    square)."""
    size = dataT.element_size()
    split = kind == "split"
    rows = dataT.shape[0] * dataT.shape[2]
    return bound(dataT.numel() * size, idx.numel() * 4, m, ncols or rows,
                 size, (6 if split else 2) * dataT.numel() * m,
                 PEAK_FLOPS["bf16" if split else kind], npad_out=rows)[0]


def b3_cases(libs, kind, dataT, idx, X):
    """B3's versions on X, each held to the plain product: (errors,
    failures, {name: fn} of the versions that pass)."""
    ref = bsr.bsr_matmat_plain(dataT, idx, X)
    errs, failed, fns = {}, [], {}
    for name, lib in libs.items():
        fn = (lambda lib=lib: apply(lib, dataT, idx, X))
        errs[name] = err = float((fn().double() - ref.double()).abs().max()
                                 / ref.double().abs().max())
        if err <= TOL[kind]:
            fns[name] = fn
        else:
            failed.append(f"{name} rel err {err:.3e} > {TOL[kind]:.0e}")
    return errs, failed, fns


def split_cases(libs, op, X):
    """The split kernel's versions on X, each held to the exact split
    product and by its signature beside the f64 product of the f32 data,
    and compared bit for bit with the first version ("change"); the
    package's B3 on the f32 blocks ("highest") is timed beside them."""
    hi, lo, idx = op.dataT_hi, op.dataT_lo, op.idx
    nbpr, B = hi.shape[1], hi.shape[2]
    exact = bsr.bsr_matmat_split_plain(hi, lo, idx, X, acc=torch.float64)
    y64 = bsr.bsr_matmat_plain(op.dataT.double(), idx, X.double())
    tol = split_tol(nbpr, B)
    errs, failed, fns, first = {}, [], {}, None
    for name, lib in libs.items():
        fn = (lambda lib=lib: apply_split(lib, hi, lo, idx, X))
        y = fn()
        if first is None:
            first = y
        else:
            print(f"[split m={X.shape[0]}] {name} bit for bit as change: "
                  f"{bool(torch.equal(y, first))}", flush=True)
        errs[name] = err = float((y.double() - exact).abs().max()
                                 / exact.abs().max())
        t = signature(y, exact, y64)
        if err <= tol and abs(t) <= SIGNATURE_TOL:
            fns[name] = fn
        else:
            failed.append(f"{name} rel err {err:.3e} (tol {tol:.0e}), "
                          f"signature {t:+.4f} (tol {SIGNATURE_TOL})")
    fns["B3 highest"] = lambda: bsr.bsr_matmat(op.dataT, idx, X)
    return errs, failed, fns


def b1_cases(libs, kind, dataT, idx, x, square):
    """The single-vector versions on one block-row range ``dataT``/``idx``
    with the whole x, each held to the plain product, compared bit for bit
    with "change" and, for a row block, with its own square rows
    (``square``: {name: y} of the square launch, or None): (errors,
    failures, {name: fn} of the versions that pass, plus the package's
    wrapper and the library call, {name: y} of the versions)."""
    ncb = x.numel() // dataT.shape[2]
    rows = slice(0, dataT.shape[0] * dataT.shape[2])
    ref = bsr.bsr_matvec_plain(dataT, idx, x)
    errs, failed, fns, ys, first = {}, [], {}, {}, None
    for name, lib in libs.items():
        fn = (lambda lib=lib: apply_b1(lib, dataT, idx, x))
        y = fn()
        if first is None:
            first = y
        else:
            print(f"[b1 {kind}] {name} bit for bit as change: "
                  f"{bool(torch.equal(y, first))}", flush=True)
        if square is not None and not torch.equal(y, square[name][rows]):
            failed.append(f"{name}: row block differs from its square rows")
        errs[name] = err = float((y.double() - ref.double()).abs().max()
                                 / ref.double().abs().max())
        if err <= TOL[kind]:
            fns[name] = fn
        else:
            failed.append(f"{name} rel err {err:.3e} > {TOL[kind]:.0e}")
        ys[name] = y
    cols = {} if ncb == dataT.shape[0] else {"ncb": ncb}
    fns["package"] = lambda: bsr.bsr_matvec(dataT, idx, x, **cols)
    # how fast this card streams the same bytes at all: one reduction over
    # the blocks, which reads each once (not the same function: no result)
    fns["read"] = lambda: dataT.sum()
    A = sparse_bsr(dataT, idx, x.numel())
    err = float(((A @ x).double() - ref.double()).abs().max()
                / ref.double().abs().max())
    if err <= TOL[kind]:
        fns["library"] = lambda: A @ x
    else:
        print(f"[b1 {kind}] library disagrees with the plain product: "
              f"{err:.2e}", flush=True)
    return errs, failed, fns, ys


def ptxas_report(src):
    """ptxas's register, spill and warning lines for one source, built as the
    package builds it (``ops/kernels.py``) with ``-Xptxas -v``."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as d:
        proc = subprocess.run(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(Path(d) / "lib.so"), str(src)],
            capture_output=True, text=True, check=True)
    return [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
            if "registers" in line or "spill" in line
            or "Compiling entry" in line or "arning" in line]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=list(SOURCES), default="b3",
                    help="B3 (csrc/bsr_spmm.cu), its bf16x3 form "
                    "(csrc/bsr_spmm_split.cu) or the single-vector apply "
                    "(B3's kernel with one vector)")
    ap.add_argument("--parent", help="root of another checkout whose copy "
                    "of the kernel's source is timed too")
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=FILE", help="another source file of the "
                    "kernel, timed as NAME")
    ap.add_argument("--lanes", help="lane counts (default: "
                    + "; ".join(f"{k} {v}" for k, v in LANES.items()) + ")")
    ap.add_argument("--dtypes", default="f32,f64",
                    help="B3's types (the split kernel takes f32 only)")
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
    split = args.kernel == "split"
    source = SOURCES[args.kernel]
    versions = {"change": kernels.CSRC / source}
    if args.parent:
        csrc = Path(args.parent) / "eigensolvers_tpu_torch" / "csrc"
        old = csrc / OLD_B1
        versions["parent"] = (old if args.kernel == "b1" and old.exists()
                              else csrc / source)
    for v in args.variant:
        name, _, src = v.partition("=")
        versions[name] = Path(src)
    with ThreadPoolExecutor(len(versions)) as pool:
        loader = {"b3": load, "split": load_split,
                  "b1": load_b1}[args.kernel]
        libs = dict(zip(versions, pool.map(loader, versions.values())))
        reports = pool.map(ptxas_report, versions.values()) \
            if args.ptxas else ()
        for name, lines in zip(versions, reports):
            for line in lines:
                print(f"[ptxas {name}] {line}")

    H_out, h_in = slice_factors()
    lanes = [int(m) for m in
             (args.lanes or LANES.get(args.kernel, "1")).split(",")]
    rows, failed = [], []

    def run(kind, tag, errs, bad, fns, bnd, m=1):
        """Time ``fns`` in turns (and, for B1, their device time) and
        record the row."""
        for line in bad:
            failed.append(f"{kind} {tag} {line}")
            print(f"[{kind} {tag}] {line}", flush=True)
        order = list(fns) + list(fns)[::-1]
        times = {n: [] for n in fns}
        for name in order:
            times[name].append(time_ms(fns[name], args.reps))
        row = dict(card=card, kernel=args.kernel, dtype=kind, m=m, shape=tag,
                   bound_ms=bnd, ms={n: min(t) for n, t in times.items()},
                   turns=times, rel_err=errs)
        if args.kernel == "b1":
            row["device_ms"] = {n: device_ms(fn, args.reps)
                                for n, fn in fns.items()}
            row["host_us"] = {n: host_us(fn) for n, fn in fns.items()}
        if args.clocks:
            row["clocks"] = {n: clocks(fn) for n, fn in fns.items()}
            print(f"[{kind} {tag}] median SM MHz, W under load: " + "; ".join(
                f"{n} {c[0]:.0f}, {c[1]:.0f}" for n, c in
                row["clocks"].items()), flush=True)
        rows.append(row)
        dms, hus = row.get("device_ms", {}), row.get("host_us", {})
        print(f"[{kind} {tag}] bound {bnd:.4f} ms; " + "; ".join(
            f"{n} {min(t):.4f} ms ({bnd / min(t):.0%}; "
            f"{t[0]:.4f}/{t[1]:.4f}; rel err {errs.get(n, 0):.1e}"
            + (f"; device {dms[n]:.4f} ms, gap {min(t) - dms[n]:.4f}"
               if dms.get(n) is not None else "")
            + (f"; host {hus[n]:.1f} us" if n in hus else "") + ")"
            for n, t in times.items()), flush=True)

    for kind in ("split",) if split else args.dtypes.split(","):
        op = product.kron_sum_bsr(H_out, h_in, BANDWIDTH,
                                  DTYPES["f32" if split else kind], dev,
                                  precision="high" if split else "highest")
        if args.diag:
            op.idx = torch.arange(op.idx.shape[0], dtype=torch.int32,
                                  device=dev)[:, None].expand(
                                      op.idx.shape).contiguous()
        Xall = torch.as_tensor(np.random.RandomState(0).standard_normal(
            (1 if args.kernel == "b1" else max(lanes), op.n_padded)),
            dtype=op.dtype, device=dev)
        if args.kernel == "b1":
            x = Xall[0]
            nrb = op.dataT.shape[0]
            per = nrb // ROW_RANGES
            *res, square = b1_cases(libs, kind, op.dataT, op.idx, x, None)
            run(kind, "square", *res, bound_ms(op.dataT, op.idx, 1, kind))
            d, i = op.dataT[:per], op.idx[:per]
            *res, _ = b1_cases(libs, kind, d, i, x, square)
            run(kind, f"rows [0, {per}) of {nrb}", *res,
                bound_ms(d, i, 1, kind, ncols=x.numel()))
            del square, res
        for m in [] if args.kernel == "b1" else lanes:
            X = Xall[:m].contiguous()
            errs, bad, fns = (split_cases(libs, op, X) if split else
                              b3_cases(libs, kind, op.dataT, op.idx, X))
            run(kind, f"m={m}", errs, bad, fns,
                bound_ms(op.dataT, op.idx, m, kind), m)
        del op, Xall
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    if failed:
        raise SystemExit("bench_spmm: " + "; ".join(failed))


if __name__ == "__main__":
    main()
