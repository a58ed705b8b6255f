#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``eigensolvers_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device: requires CUDA (no CPU fallback), prints the card's name and
   power limit, sets and checks TF32 off;
2. build: compiles the block-ELL kernels from ``csrc/`` with nvcc, one
   process per source, started together;
3. kernels vs plain PyTorch on the card, at the slice shape and at ragged
   small shapes, with errors and CUDA-event timings: the single-vector SpMV
   (B1 ``bsr_spmv``, B2 ``bsr_spmv_split``) and the multi-vector product
   (B3 ``bsr_spmm``, ``bsr_spmm_split``) for m = 1, 2, 4, 8 vectors and
   across the kernel's chunk of 8; the bf16x3 kernels against the exact
   split product, with a signature that tells them from a true-f32 product;
4. the slice through the public entry points, on a block-sparse 2-mode
   vibrational Hamiltonian with n = 262,144 and 1.21 GB of f32 block data
   on the card, each run checked against the exact spectrum and by an f64
   residual, with the kernel launch counts of each run (counters zeroed just
   before it) equal to the operator applies it reports:
   - inexact Lanczos, one vector, at "highest" (B1) and "high" (B2);
   - (a) ``fastLanczosDiagonalization`` with nBlock = 2 at "highest" and
     (b) at "high": batched MINRES lanes and the fused step, every apply a
     lane stack through B3;
   - (c) inexact Lanczos with nBlock = 2 and batched block solves at
     "highest" (B3 for the solves and projections, B1 for the extends);
   - (d) the dense bench headline task (n = 2048) in f32 through
     ``fastLanczosDiagonalization`` (cuBLAS, no hand-written kernel);
5. a JSON line of per-kernel results, the ``nvidia-smi`` name/power line,
   and a final JSON status line.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# -- the slice's problem (see eigensolvers_tpu_torch/models/product.py) ------
M_OUT, B_IN, BANDWIDTH = 2048, 128, 4          # n = 262,144; nbpr = 9
OMEGA_OUT, LAM, OMEGA_IN, X_RANGE = 1.0, 1e-3, 1.3, (-7.0, 7.0)
TARGET_LEVEL = 20                              # sigma between levels 20 and 21
LANCZOS = dict(L=12, maxit=8, eConv=1e-7, checkFitTol=1e-5)
LINEAR = dict(linearSolver="minres", linearIter=20000, linear_tol=1e-2,
              linear_atol=1e-2, preconditioner="jacobi",
              errorOnNonConvergence=False)
NBLOCK = 2
LANES = (1, 2, 4, 8)                           # B3 at the slice shape
# the dense headline task of bench.py (bench_lanczos_headline)
HEADLINE = dict(n=2048, target_index=1316, L=30, maxit=10, eConv=1e-6)
HEADLINE_LINEAR = dict(linearSolver="minres", linearIter=8000,
                       linear_tol=1e-4, linear_atol=1e-4,
                       errorOnNonConvergence=False)
HEADLINE_TOL = 1e-2                            # bench.py's bound on the card
# Tolerances.  Eigenvalue, relative to the exact level: "highest" is an f32
# Rayleigh-Ritz of an operator whose dense kinetic blocks cancel to small
# energies (CPU rehearsal: 1e-7..4e-7), so 1e-5; "high" (bf16x3) holds each
# block element only to about 2^-16 relative, and the DVR kinetic diagonal
# (~135) is 18x the target level, so the operator it applies differs from H
# element by element by up to ~3e-4 of the level: 2e-4, the bound
# tests/test_torch_lanczos.py uses at the small size.  Residual:
# ||Hv - lam v|| / ||H|| in f64.  Kernels: max |y - y_plain| / max |y_plain|,
# summation-order roundoff in the working type (f64, f32).  The bf16x3 split
# kernels are held to the exact split product (the same products summed in
# f64) two ways.  Max error: their f32 summation order alone, which grows
# with the N = nbpr * B terms of a row: 2e-6 up to N = 1152 (the slice's),
# where a true-f32 product reads 3.5e-6 and more; 5e-6 at N = 2048, where
# the roundoff itself reaches 3.5e-6.  Signature (see ``signature``): |t| <=
# 0.1 for the kernels, while a true-f32 product, checked alongside, has
# |1 - t| <= 0.1 at every N.  Their accuracy against the f64 product of the
# f32 data is the method's error: 1e-5 for one vector (B2), 2e-5 for the
# largest of m lanes (B3).
EV_RTOL = {"highest": 1e-5, "high": 2e-4}
RES_TOL = 1e-6
KERNEL_TOL = {"f64": 1e-12, "f32": 1e-5, "split": 2e-6, "split_long": 5e-6,
              "split_f64": 1e-5, "split_lanes": 2e-5, "signature": 0.1}


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def relerr(y, ref):
    return float((y.double() - ref.double()).abs().max()
                 / ref.double().abs().max())


def split_tol(nbpr, B):
    """The split kernels' bound against the exact split product."""
    return KERNEL_TOL["split" if nbpr * B <= 1152 else "split_long"]


def signature(y, exact, y64):
    """t = <y - exact, d> / <d, d> with d = y64 - exact, the split's own
    error: the share of it that y carries, ~0 for a bf16x3 product (its
    roundoff does not align with d) and ~1 for a true-f32 product."""
    d = y64.double() - exact.double()
    return float(((y.double() - exact.double()) * d).sum() / (d * d).sum())


def time_ms(torch, fn, reps=30, warmup=3):
    """Median CUDA-event time of ``fn`` in ms over ``reps`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def compare(torch, name, kern, plain, ref, tol, gb):
    """Hold a kernel against its plain version (or ``ref``) and time both in
    turns (plain, kernel, kernel, plain); returns the result dict."""
    yk = kern()
    torch.cuda.synchronize()
    yp = plain() if ref is None else ref
    torch.cuda.synchronize()
    err = relerr(yk, yp)
    abs_err = float((yk.double() - yp.double()).abs().max())
    require(np.isfinite(err) and err <= tol,
            f"{name} relative error {err:.3e} > {tol:.0e}")
    del yk, yp
    ms_p1 = time_ms(torch, plain)
    ms_k1 = time_ms(torch, kern)
    ms_k2 = time_ms(torch, kern)
    ms_p2 = time_ms(torch, plain)
    ms_k, ms_p = min(ms_k1, ms_k2), min(ms_p1, ms_p2)
    print(f"[kernel] {name}: rel err {err:.3e} (tol {tol:.0e}); kernel "
          f"{ms_k:.4f} ms ({gb / ms_k * 1e3:.0f} GB/s of block data), plain "
          f"{ms_p:.4f} ms; medians of 30 (kernel {ms_k1:.4f}/{ms_k2:.4f}, "
          f"plain {ms_p1:.4f}/{ms_p2:.4f})", flush=True)
    return dict(max_rel_err=err, max_abs_err=abs_err, ms=ms_k, plain_ms=ms_p)


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from eigensolvers_tpu_torch import (TorchVector, calculateTarget,
                                            inexactLanczosDiagonalization)
        from eigensolvers_tpu_torch.models import product
        from eigensolvers_tpu_torch.models.synthetic import \
            known_spectrum_matrix
        from eigensolvers_tpu_torch.ops import kernels, sparse as bsr
        from eigensolvers_tpu_torch.ops.operators import DenseOperator
        from eigensolvers_tpu_torch.solvers.fast_lanczos import \
            fastLanczosDiagonalization
    except ImportError as e:
        raise SystemExit(f"chip_smoke: the eigensolvers_tpu_torch package "
                         f"is not beside this script ({e})")

    # -- 1. device ----------------------------------------------------------
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    require(not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # -- 2. build: one nvcc per source, all started together -----------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(f) for f in (kernels.bsr_spmv_library,
                                           kernels.bsr_spmm_library)]
        for b in builds:
            b.result()
    print(f"[build] bsr_spmv.cu and bsr_spmm.cu with {kernels.nvcc_path()}: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # -- 3. kernels vs plain ------------------------------------------------
    t0 = time.perf_counter()
    H_out = product.anharmonic_oscillator_fbr(M_OUT, OMEGA_OUT, LAM)
    h_in = product.sinc_dvr_oscillator(B_IN, OMEGA_IN, X_RANGE)
    e_out = np.linalg.eigvalsh(H_out)
    e_in = np.linalg.eigvalsh(h_in)
    op32 = product.kron_sum_bsr(H_out, h_in, BANDWIDTH, torch.float32, dev,
                                precision="highest")
    op64 = product.kron_sum_bsr(H_out, h_in, BANDWIDTH, torch.float64, dev)
    op_high = bsr.BSROperator(op32.dataT, op32.idx, op32.n, precision="high")
    torch.cuda.synchronize()
    nrb, nbpr, B, _ = op32.dataT.shape
    gb32 = op32.dataT.numel() * 4 / 1e9
    print(f"[setup] dataT {tuple(op32.dataT.shape)}: {gb32:.3f} GB f32, "
          f"{2 * gb32:.3f} GB f64; host eigh + assembly "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    rng = np.random.RandomState(0)
    X64 = torch.as_tensor(rng.standard_normal((max(LANES), op32.n_padded)),
                          device=dev)
    X32 = X64.float()
    x64, x32 = X64[0].contiguous(), X32[0].contiguous()
    idx = op32.idx
    hi, lo = op_high.dataT_hi, op_high.dataT_lo
    # the split kernels' oracles: the exact split product (the same bf16x3
    # products summed in f64) and the f64 product of the f32 data
    d32_64 = op32.dataT.double()
    ref32 = bsr.bsr_matvec_plain(d32_64, idx, x32.double())
    refX = bsr.bsr_matmat_plain(d32_64, idx, X32.double())
    del d32_64
    exactX = bsr.bsr_matmat_split_plain(hi, lo, idx, X32, acc=torch.float64)
    shape = tuple(op32.dataT.shape)

    def split_checks(name, y, exact, y_f32, ref64, tol64):
        """A split kernel's result y against the f64 product of the f32 data
        (the method's error) and by its signature, beside a true-f32
        product, which the checks must tell from it."""
        e64, e32 = relerr(y, ref64), relerr(y_f32, exact)
        t, t32 = signature(y, exact, ref64), signature(y_f32, exact, ref64)
        print(f"[kernel] {name} against the f64 product of the f32 data: rel "
              f"err {e64:.3e} (tol {KERNEL_TOL[tol64]:.0e}); signature "
              f"{t:+.4f}; an f32 product: signature {t32:+.4f}, rel err "
              f"against the exact split {e32:.3e}", flush=True)
        require(e64 <= KERNEL_TOL[tol64], f"{name} vs f64: {e64:.3e}")
        require(abs(t) <= KERNEL_TOL["signature"], f"{name}: signature {t}")
        require(abs(1 - t32) <= KERNEL_TOL["signature"]
                and e32 > KERNEL_TOL["split"], f"{name}: the checks cannot "
                f"tell an f32 product from the split ({t32}, {e32:.3e})")

    results = {}
    for name, kern, plain, ref, tol, gb in (
            ("bsr_spmv f32", lambda: bsr.bsr_matvec(op32.dataT, idx, x32),
             lambda: bsr.bsr_matvec_plain(op32.dataT, idx, x32), None,
             KERNEL_TOL["f32"], gb32),
            ("bsr_spmv f64", lambda: bsr.bsr_matvec(op64.dataT, idx, x64),
             lambda: bsr.bsr_matvec_plain(op64.dataT, idx, x64), None,
             KERNEL_TOL["f64"], 2 * gb32),
            ("bsr_spmv_split", lambda: bsr.bsr_matvec_split(hi, lo, idx, x32),
             lambda: bsr.bsr_matvec_split_plain(hi, lo, idx, x32),
             exactX[0], split_tol(nbpr, B), gb32)):
        results[name] = compare(torch, f"{name} at {shape}", kern, plain,
                                ref, tol, gb)
    split_checks("bsr_spmv_split", bsr.bsr_matvec_split(hi, lo, idx, x32),
                 exactX[0], bsr.bsr_matvec(op32.dataT, idx, x32), ref32,
                 "split_f64")
    for m in LANES:
        Xm32, Xm64 = X32[:m].contiguous(), X64[:m].contiguous()
        for name, kern, plain, ref, tol, gb in (
                ("bsr_spmm f32",
                 lambda: bsr.bsr_matmat(op32.dataT, idx, Xm32),
                 lambda: bsr.bsr_matmat_plain(op32.dataT, idx, Xm32), None,
                 KERNEL_TOL["f32"], gb32),
                ("bsr_spmm f64",
                 lambda: bsr.bsr_matmat(op64.dataT, idx, Xm64),
                 lambda: bsr.bsr_matmat_plain(op64.dataT, idx, Xm64), None,
                 KERNEL_TOL["f64"], 2 * gb32),
                ("bsr_spmm_split",
                 lambda: bsr.bsr_matmat_split(hi, lo, idx, Xm32),
                 lambda: bsr.bsr_matmat_split_plain(hi, lo, idx, Xm32),
                 exactX[:m], split_tol(nbpr, B), gb32)):
            results[(name, m)] = compare(torch, f"{name} m={m} at {shape}",
                                         kern, plain, ref, tol, gb)
        split_checks(f"bsr_spmm_split m={m}",
                     bsr.bsr_matmat_split(hi, lo, idx, Xm32), exactX[:m],
                     bsr.bsr_matmat(op32.dataT, idx, Xm32), refX[:m],
                     "split_lanes")
    del ref32, refX, exactX, X64, X32, x64, x32

    # ragged small shapes, up to the largest block the kernels take
    for nr, nb, Bs in ((5, 3, 32), (5, 3, 64), (5, 3, 100), (2, 2, 1024)):
        r = np.random.RandomState(Bs)
        d64 = torch.as_tensor(r.standard_normal((nr, nb, Bs, Bs)),
                              device=dev)
        i5 = torch.as_tensor(r.randint(0, nr, (nr, nb)), dtype=torch.int32,
                             device=dev)
        V64 = torch.as_tensor(r.standard_normal((17, nr * Bs)), device=dev)
        d32, V32 = d64.float(), V64.float()
        v64, v32 = V64[0].contiguous(), V32[0].contiguous()
        h5 = d32.to(torch.bfloat16)
        l5 = (d32 - h5.float()).to(torch.bfloat16)
        exact = bsr.bsr_matmat_split_plain(h5, l5, i5, V32, acc=torch.float64)
        ref64 = bsr.bsr_matmat_plain(d32.double(), i5, V32.double())
        tol_s = split_tol(nb, Bs)
        y2 = bsr.bsr_matvec_split(h5, l5, i5, v32)
        # (key, kernel result, reference, bound)
        cases = [
            ("B1 f64", bsr.bsr_matvec(d64, i5, v64),
             bsr.bsr_matvec_plain(d64, i5, v64), KERNEL_TOL["f64"]),
            ("B1 f32", bsr.bsr_matvec(d32, i5, v32),
             bsr.bsr_matvec_plain(d32, i5, v32), KERNEL_TOL["f32"]),
            ("B2", y2, exact[0], tol_s),
            ("B2 vs f64", y2, ref64[0], KERNEL_TOL["split_f64"])]
        # (key, result, lanes, the signature it must have)
        sigs = [("B2", y2, 1, 0.0), ("f32", bsr.bsr_matvec(d32, i5, v32), 1,
                                     1.0)]
        for m in (1, 3, 9, 17):            # across the kernel's chunk of 8
            W64, W32 = V64[:m].contiguous(), V32[:m].contiguous()
            Ys = bsr.bsr_matmat_split(h5, l5, i5, W32)
            cases += [
                (f"B3 f64 m={m}", bsr.bsr_matmat(d64, i5, W64),
                 bsr.bsr_matmat_plain(d64, i5, W64), KERNEL_TOL["f64"]),
                (f"B3 f32 m={m}", bsr.bsr_matmat(d32, i5, W32),
                 bsr.bsr_matmat_plain(d32, i5, W32), KERNEL_TOL["f32"]),
                (f"B3 split m={m}", Ys, exact[:m], tol_s)]
            sigs += [(f"B3 split m={m}", Ys, m, 0.0),
                     (f"f32 m={m}", bsr.bsr_matmat(d32, i5, W32), m, 1.0)]
        torch.cuda.synchronize()
        errs, ts = [], []
        for key, yk, yp, tol in cases:
            e = relerr(yk, yp)
            require(e <= tol, f"ragged {(nr, nb, Bs)} {key} rel err {e:.3e}")
            errs.append(f"{key} {e:.1e}")
        for key, y, lanes, want in sigs:
            rows = slice(0, lanes) if y.ndim == 2 else 0
            t = signature(y, exact[rows], ref64[rows])
            require(abs(t - want) <= KERNEL_TOL["signature"],
                    f"ragged {(nr, nb, Bs)} {key} signature {t:.4f}")
            ts.append(f"{key} {t:+.3f}")
        print(f"[kernel] ragged nrb={nr} nbpr={nb} B={Bs}: rel err "
              + ", ".join(errs) + "; signature " + ", ".join(ts), flush=True)

    # -- 4. the slice -------------------------------------------------------
    levels = product.kron_sum_levels(e_out, e_in, TARGET_LEVEL + 12)
    sigma = float(levels[TARGET_LEVEL]
                  + 0.2 * (levels[TARGET_LEVEL + 1] - levels[TARGET_LEVEL]))
    nearest2 = np.sort(levels[np.argsort(np.abs(levels - sigma))[:NBLOCK]])
    h_norm = max(abs(e_out[-1] + e_in[-1]), abs(e_out[0] + e_in[0]))
    # Low-energy random guesses: random amplitudes on the 32 lowest outer HO
    # functions times random smooth (polynomial x Gaussian) inner packets,
    # both parities in both modes; the block's two are orthonormalized.
    xg = np.linspace(X_RANGE[0], X_RANGE[1], B_IN)
    packets = np.stack([xg ** p * np.exp(-xg ** 2 / 2) for p in range(4)])
    guesses = np.zeros((NBLOCK, M_OUT, B_IN))
    for s in range(NBLOCK):
        guesses[s, :32] = np.random.RandomState(s).standard_normal(
            (32, 4)) @ packets
    block = np.linalg.qr(guesses.reshape(NBLOCK, -1).T)[0].T

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = torch.zeros((), device=dev)
    for _ in range(200):
        s = s + 1
        bool(s > 0)
    host_read_us = (time.perf_counter() - t0) / 200 * 1e6

    def vectors(rows, report):
        opts = {"linearSystemArgs": dict(LINEAR, report=report)}
        return [TorchVector(torch.as_tensor(r, dtype=torch.float32,
                                            device=dev), opts) for r in rows]

    def run(fn, *args, **kw):
        """One main-path run with the kernel counters zeroed just before it
        and read just after; returns (result, wall, counts, warnings)."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.synchronize()
            bsr.reset_launch_counts()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(bsr.launches)
        return out, wall, counts, sum("did not converge" in str(w.message)
                                      for w in caught)

    def check_states(tag, prec, ev, Y, want):
        """The len(want) Ritz pairs nearest sigma against the exact levels
        (relative error) and by their f64 residual."""
        ev = np.asarray(ev)
        require(np.all(np.isfinite(ev)) and len(ev) == len(Y),
                f"{tag}: bad eigenvalues {ev}")
        picks = np.argsort(np.abs(ev - sigma))[:len(want)]
        picks = picks[np.argsort(ev[picks])]
        rels, ress = [], []
        for k, exact in zip(picks, want):
            v = Y[k].array
            require(tuple(v.shape) == (op32.n,) and v.dtype == torch.float32
                    and bool(torch.isfinite(v).all()),
                    f"{tag}: bad Ritz vector {tuple(v.shape)} {v.dtype}")
            v64 = v.double()
            r = bsr.bsr_matvec_plain(op64.dataT, op64.idx, v64) - ev[k] * v64
            rels.append(abs(ev[k] - exact) / abs(exact))
            ress.append(float(torch.linalg.vector_norm(r)
                              / torch.linalg.vector_norm(v64)) / h_norm)
        print(f"[slice {tag}] Ritz {', '.join(f'{ev[k]:.8f}' for k in picks)}"
              f" exact {', '.join(f'{e:.8f}' for e in want)}; rel err "
              f"{', '.join(f'{e:.2e}' for e in rels)} (tol "
              f"{EV_RTOL[prec]:.0e}); ||Hv-lv||/||H|| "
              f"{', '.join(f'{e:.2e}' for e in ress)} (tol {RES_TOL:.0e})",
              flush=True)
        require(max(rels) <= EV_RTOL[prec], f"{tag}: eigenvalue rel err "
                f"{max(rels):.2e}")
        require(max(ress) <= RES_TOL, f"{tag}: residual {max(ress):.2e}")

    def check_counts(tag, counts, expected):
        """Every BSR kernel's launches in the run equal the applies the
        run reports for it; kernels not named launch 0 times."""
        want = {k: expected.get(k, 0) for k in counts}
        require(counts == want, f"{tag}: launches {counts}, the run "
                f"reports {want}")
        require(any(want.values()) or tag == "(d) dense",
                f"{tag}: no kernel launched")

    def report_line(tag, status, report, wall, unconverged):
        applies = report.get("matvecs", 0) + report.get("matmats", 0)
        print(f"[slice {tag}] converged {status['isConverged']} after "
              f"{status['cumIter']} Krylov steps; {report['solves']} solves, "
              f"{report['iterations']} MINRES iterations ({unconverged} "
              f"solves above tolerance); {report.get('matvecs', 0)} "
              f"single-vector and {report.get('matmats', 0)} lane-stack "
              f"applies by the solves and steps; wall {wall:.2f} s, "
              f"{wall / max(applies, 1) * 1e3:.4f} ms/apply; phases: "
              + ", ".join(f"{p} {t['seconds']:.2f} s ({t['calls']})"
                          for p, t in status["timers"].items()), flush=True)

    torch.cuda.reset_peak_memory_stats()
    totals = dict.fromkeys(bsr.launches, 0)
    walls = {}
    # inexact Lanczos, one vector: B1 / B2 for the solves and extends, B3
    # for the projected H at the start and after each restart
    for prec, op, single, multi, case in (
            ("highest", op32, "bsr_spmv", "bsr_spmm", "bsr_spmv f32"),
            ("high", op_high, "bsr_spmv_split", "bsr_spmm_split",
             "bsr_spmv_split")):
        report = {}
        with tempfile.TemporaryDirectory() as d:
            summ = os.path.join(d, "summary_lanczos.out")
            (ev, Y, status), wall, counts, unconv = run(
                inexactLanczosDiagonalization, op,
                vectors(block[:1], report)[0], sigma, writeOut=True,
                outFileName=os.path.join(d, "iterations_lanczos.out"),
                summaryFileName=summ, **LANCZOS)
            with open(summ) as f:
                summary = f.read()
        require("startingPoint" in summary and "endingPoint" in summary,
                f"{prec}: summary_lanczos.out lacks its sentinels")
        tag = f"{prec}, nBlock 1"
        check_states(tag, prec, ev, Y, [float(levels[TARGET_LEVEL])])
        report_line(tag, status, report, wall, unconv)
        extends = status["timers"]["extend_subspace"]["calls"]
        check_counts(tag, counts, {
            single: report["matvecs"] + extends,
            multi: 1 + status["restarts"]})
        print(f"[slice {tag}] {single} launches {counts[single]} = "
              f"{report['matvecs']} in solves + {extends} extends; {multi} "
              f"launches {counts[multi]} = 1 + {status['restarts']} restarts "
              f"(projected H); SpMV kernel share of wall (launches x "
              f"phase-3 kernel time) "
              f"{counts[single] * results[case]['ms'] / 1e3 / wall:.3f}",
              flush=True)
        walls[tag] = wall
        for k, v in counts.items():
            totals[k] += v

    # (a), (b): the fused driver with a block of two; every apply is a lane
    # stack (guess block, batched MINRES, new H columns, restarts)
    for prec, op, multi in (("highest", op32, "bsr_spmm"),
                            ("high", op_high, "bsr_spmm_split")):
        report = {}
        tag = f"({'a' if prec == 'highest' else 'b'}) fast {prec}, nBlock 2"
        (ev, Y, status), wall, counts, unconv = run(
            fastLanczosDiagonalization, op, vectors(block, report), sigma,
            LANCZOS["L"], LANCZOS["maxit"], LANCZOS["eConv"])
        check_states(tag, prec, ev, Y, nearest2)
        report_line(tag, status, report, wall, unconv)
        check_counts(tag, counts, {multi: report["matmats"]})
        walls[tag] = wall
        for k, v in counts.items():
            totals[k] += v

    # (c): the general driver with a block of two and batched block solves
    report = {}
    tag = "(c) general highest, nBlock 2, batched"
    (ev, Y, status), wall, counts, unconv = run(
        inexactLanczosDiagonalization, op32, vectors(block, report), sigma,
        writeOut=False, batchBlockSolves=True, **LANCZOS)
    check_states(tag, "highest", ev, Y, nearest2)
    report_line(tag, status, report, wall, unconv)
    extends = status["timers"]["extend_subspace"]["calls"]
    check_counts(tag, counts, {"bsr_spmm": report["matmats"] + 1
                               + status["restarts"], "bsr_spmv": extends})
    print(f"[slice {tag}] bsr_spmm launches {counts['bsr_spmm']} = "
          f"{report['matmats']} in batched solves + 1 + {status['restarts']} "
          f"restarts (projected H); bsr_spmv launches {counts['bsr_spmv']} = "
          f"{extends} extends", flush=True)
    walls[tag] = wall
    for k, v in counts.items():
        totals[k] += v
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # (d): the dense headline task, f32 on the card
    n = HEADLINE["n"]
    Hd, evd = known_spectrum_matrix(n, eigenvalues=np.linspace(1, 1400, n),
                                    seed=10, dtype=np.float32)
    sig_d = float(calculateTarget(evd, HEADLINE["target_index"]))
    truth = float(evd[np.argmin(np.abs(evd - sig_d))])
    opd = DenseOperator(Hd, device=dev)
    report = {}
    gd = TorchVector(torch.as_tensor(np.random.RandomState(3).rand(n),
                                     dtype=torch.float32, device=dev),
                     {"linearSystemArgs": dict(HEADLINE_LINEAR,
                                               report=report)})
    tag = "(d) dense"
    (ev, Y, status), wall, counts, unconv = run(
        fastLanczosDiagonalization, opd, gd, sig_d, HEADLINE["L"],
        HEADLINE["maxit"], HEADLINE["eConv"])
    got = float(np.asarray(ev)[np.argmin(np.abs(np.asarray(ev) - sig_d))])
    print(f"[slice {tag}] n={n} sigma={sig_d:.6f} nearest Ritz {got:.6f} "
          f"truth {truth:.6f} |err| {abs(got - truth):.2e} (tol "
          f"{HEADLINE_TOL:.0e})", flush=True)
    report_line(tag, status, report, wall, unconv)
    require(abs(got - truth) < HEADLINE_TOL,
            f"{tag}: nearest {got} vs truth {truth}")
    require(Y[0].array.is_cuda, f"{tag}: Ritz vectors left the card")
    check_counts(tag, counts, {})
    walls[tag] = wall
    print(f"[slice] peak device memory of the BSR runs {peak_gb:.3f} GB; "
          f"host read of one device scalar {host_read_us:.1f} us (one per "
          f"MINRES iteration); walls: " + ", ".join(
              f"{k} {v:.2f} s" for k, v in walls.items()), flush=True)
    for k, v in totals.items():
        require(v > 0, f"{k} was never launched by the main path")

    # -- 5. results ---------------------------------------------------------
    src = "eigensolvers_tpu_torch/csrc/"
    b3 = "eigensolvers_tpu/ops/sparse.py:294 (_bsr_matmat_xla, XLA)"

    def entry(name, source, replaces, key):
        r = results[key]
        return dict(name=name, route="cuda", source=src + source,
                    replaces=replaces, launches=totals[name],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"])

    line = {"kernels": [
        entry("bsr_spmv", "bsr_spmv.cu",
              "eigensolvers_tpu/ops/sparse.py:440", "bsr_spmv f32"),
        entry("bsr_spmv_split", "bsr_spmv.cu",
              "eigensolvers_tpu/ops/sparse.py:479", "bsr_spmv_split"),
        # B3 at the main path's lane count (the block of two)
        entry("bsr_spmm", "bsr_spmm.cu", b3, ("bsr_spmm f32", NBLOCK)),
        entry("bsr_spmm_split", "bsr_spmm.cu", b3,
              ("bsr_spmm_split", NBLOCK)),
    ]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
