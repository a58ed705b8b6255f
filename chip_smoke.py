#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``eigensolvers_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device: requires CUDA (no CPU fallback), prints the card's name and
   power limit, sets and checks TF32 off;
2. build: compiles the block-ELL SpMV kernels from ``csrc/`` with nvcc;
3. kernels vs plain PyTorch on the card, at the slice shape and at ragged
   small shapes, with errors and CUDA-event timings;
4. the slice through the public entry points: inexact shift-and-invert
   Lanczos (``TorchVector`` + ``inexactLanczosDiagonalization``) on a
   block-sparse 2-mode vibrational Hamiltonian with n = 262,144 and
   1.21 GB of f32 block data on the card, once at precision "highest"
   (B1 kernel) and once at "high" (B2 kernel), checked against the exact
   spectrum and by an f64 residual; the kernels' launch counts must match
   the matvecs the solves report;
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

import numpy as np

# -- the slice's problem (see eigensolvers_tpu_torch/models/product.py) ------
M_OUT, B_IN, BANDWIDTH = 2048, 128, 4          # n = 262,144; nbpr = 9
OMEGA_OUT, LAM, OMEGA_IN, X_RANGE = 1.0, 1e-3, 1.3, (-7.0, 7.0)
TARGET_LEVEL = 20                              # sigma between levels 20 and 21
LANCZOS = dict(L=12, maxit=8, eConv=1e-7, checkFitTol=1e-5)
LINEAR = dict(linearSolver="minres", linearIter=20000, linear_tol=1e-2,
              linear_atol=1e-2, preconditioner="jacobi",
              errorOnNonConvergence=False)
# Tolerances.  Eigenvalue, relative to the exact level: "highest" is an f32
# Rayleigh-Ritz of an operator whose dense kinetic blocks cancel to small
# energies (CPU rehearsal: 1e-7..4e-7), so 1e-5; "high" (bf16x3) holds each
# block element only to about 2^-16 relative, and the DVR kinetic diagonal
# (~135) is 18x the target level, so the operator it applies differs from H
# element by element by up to ~3e-4 of the level: 2e-4, the bound
# tests/test_torch_lanczos.py uses at the small size.  Residual:
# ||Hv - lam v|| / ||H|| in f64.  Kernels: max |y - y_plain| / max |y_plain|,
# summation-order roundoff in the working type (f64, f32), and the bf16x3
# split against the f64 product of the f32 data.
EV_RTOL = {"highest": 1e-5, "high": 2e-4}
RES_TOL = 1e-6
KERNEL_TOL = {"f64": 1e-12, "f32": 1e-5, "split": 1e-5}


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def relerr(y, ref):
    return float((y.double() - ref.double()).abs().max()
                 / ref.double().abs().max())


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


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from eigensolvers_tpu_torch import (TorchVector,
                                            inexactLanczosDiagonalization)
        from eigensolvers_tpu_torch.models import product
        from eigensolvers_tpu_torch.ops import kernels, sparse as bsr
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

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    kernels.bsr_spmv_library()
    print(f"[build] bsr_spmv.cu with {kernels.nvcc_path()}: "
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
    x64 = torch.as_tensor(rng.standard_normal(op32.n_padded), device=dev)
    x32 = x64.float()
    idx = op32.idx
    hi, lo = op_high.dataT_hi, op_high.dataT_lo
    ref32 = bsr.bsr_matvec_plain(op32.dataT.double(), idx, x32.double())
    cases = [  # name, kernel call, plain call, reference, tol, GB moved
        ("bsr_spmv f32", lambda: bsr.bsr_matvec(op32.dataT, idx, x32),
         lambda: bsr.bsr_matvec_plain(op32.dataT, idx, x32), None,
         KERNEL_TOL["f32"], gb32),
        ("bsr_spmv f64", lambda: bsr.bsr_matvec(op64.dataT, idx, x64),
         lambda: bsr.bsr_matvec_plain(op64.dataT, idx, x64), None,
         KERNEL_TOL["f64"], 2 * gb32),
        ("bsr_spmv_split", lambda: bsr.bsr_matvec_split(hi, lo, idx, x32),
         lambda: bsr.bsr_matvec_split_plain(hi, lo, idx, x32), ref32,
         KERNEL_TOL["split"], gb32),
    ]
    results = {}
    for name, kern, plain, ref, tol, gb in cases:
        yk = kern()
        torch.cuda.synchronize()
        yp = plain()
        torch.cuda.synchronize()
        err = relerr(yk, ref if ref is not None else yp)
        abs_err = float((yk.double() - (ref if ref is not None
                                        else yp).double()).abs().max())
        require(np.isfinite(err) and err <= tol,
                f"{name} relative error {err:.3e} > {tol:.0e}")
        ms_p1 = time_ms(torch, plain)
        ms_k1 = time_ms(torch, kern)
        ms_k2 = time_ms(torch, kern)
        ms_p2 = time_ms(torch, plain)
        ms_k, ms_p = min(ms_k1, ms_k2), min(ms_p1, ms_p2)
        results[name] = dict(max_rel_err=err, max_abs_err=abs_err,
                             ms=ms_k, plain_ms=ms_p)
        print(f"[kernel] {name} at {tuple(op32.dataT.shape)}: rel err "
              f"{err:.3e} (tol {tol:.0e}); kernel {ms_k:.4f} ms "
              f"({gb / ms_k * 1e3:.0f} GB/s), plain {ms_p:.4f} ms "
              f"({gb / ms_p * 1e3:.0f} GB/s); medians of 30 "
              f"(kernel {ms_k1:.4f}/{ms_k2:.4f}, plain "
              f"{ms_p1:.4f}/{ms_p2:.4f})", flush=True)
    del ref32, cases

    for Bs in (32, 64):                        # ragged small shapes
        r = np.random.RandomState(Bs)
        d64 = torch.as_tensor(r.standard_normal((5, 3, Bs, Bs)), device=dev)
        i5 = torch.as_tensor(r.randint(0, 5, (5, 3)), dtype=torch.int32,
                             device=dev)
        v64 = torch.as_tensor(r.standard_normal(5 * Bs), device=dev)
        d32, v32 = d64.float(), v64.float()
        h5 = d32.to(torch.bfloat16)
        l5 = (d32 - h5.float()).to(torch.bfloat16)
        errs = {}
        for key, yk, yp in (
                ("f64", bsr.bsr_matvec(d64, i5, v64),
                 bsr.bsr_matvec_plain(d64, i5, v64)),
                ("f32", bsr.bsr_matvec(d32, i5, v32),
                 bsr.bsr_matvec_plain(d32, i5, v32)),
                ("split", bsr.bsr_matvec_split(h5, l5, i5, v32),
                 bsr.bsr_matvec_plain(d32.double(), i5, v32.double()))):
            torch.cuda.synchronize()
            errs[key] = relerr(yk, yp)
            require(errs[key] <= KERNEL_TOL[key],
                    f"ragged (5, 3, {Bs}) {key} rel err {errs[key]:.3e}")
        print(f"[kernel] ragged nrb=5 nbpr=3 B={Bs}: rel err " + ", ".join(
            f"{k} {v:.2e}" for k, v in errs.items()), flush=True)

    # -- 4. the slice -------------------------------------------------------
    levels = product.kron_sum_levels(e_out, e_in, TARGET_LEVEL + 2)
    sigma = float(levels[TARGET_LEVEL]
                  + 0.2 * (levels[TARGET_LEVEL + 1] - levels[TARGET_LEVEL]))
    exact = float(levels[TARGET_LEVEL])
    h_norm = max(abs(e_out[-1] + e_in[-1]), abs(e_out[0] + e_in[0]))
    # Low-energy random guess: random amplitudes on the 32 lowest outer HO
    # functions times random smooth (polynomial x Gaussian) inner packets,
    # both parities in both modes.
    xg = np.linspace(X_RANGE[0], X_RANGE[1], B_IN)
    packets = np.stack([xg ** p * np.exp(-xg ** 2 / 2) for p in range(4)])
    guess = np.zeros((M_OUT, B_IN))
    guess[:32] = np.random.RandomState(0).standard_normal((32, 4)) @ packets

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = torch.zeros((), device=dev)
    for _ in range(200):
        s = s + 1
        bool(s > 0)
    host_read_us = (time.perf_counter() - t0) / 200 * 1e6

    runs = {}
    torch.cuda.reset_peak_memory_stats()
    bsr.reset_launch_counts()
    for prec, op in (("highest", op32), ("high", op_high)):
        report = {}
        opts = {"linearSystemArgs": dict(LINEAR, report=report)}
        Y0 = TorchVector(torch.as_tensor(guess.reshape(-1),
                                         dtype=torch.float32, device=dev),
                         opts)
        with tempfile.TemporaryDirectory() as d, \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = os.path.join(d, "iterations_lanczos.out")
            summ = os.path.join(d, "summary_lanczos.out")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev, Y, status = inexactLanczosDiagonalization(
                op, Y0, sigma, writeOut=True, outFileName=out,
                summaryFileName=summ, **LANCZOS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            with open(summ) as f:
                summary = f.read()
        require("startingPoint" in summary and "endingPoint" in summary,
                f"{prec}: summary_lanczos.out lacks its sentinels")
        runs[prec] = (ev, Y, status, report, wall, caught)
    counts = dict(bsr.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    for (prec, kname, kcase), (ev, Y, status, report, wall, caught) in zip(
            (("highest", "bsr_spmv", "bsr_spmv f32"),
             ("high", "bsr_spmv_split", "bsr_spmv_split")),
            runs.values()):
        ev = np.asarray(ev)
        require(np.all(np.isfinite(ev)) and len(ev) == len(Y),
                f"{prec}: bad eigenvalues {ev}")
        k = int(np.argmin(np.abs(ev - sigma)))
        v = Y[k].array
        require(tuple(v.shape) == (op32.n,) and v.dtype == torch.float32
                and bool(torch.isfinite(v).all()),
                f"{prec}: bad Ritz vector {tuple(v.shape)} {v.dtype}")
        rel = abs(ev[k] - exact) / abs(exact)
        v64 = v.double()
        r = bsr.bsr_matvec_plain(op64.dataT, op64.idx, v64) - ev[k] * v64
        res = float(torch.linalg.vector_norm(r)
                    / torch.linalg.vector_norm(v64)) / h_norm
        extends = status["timers"]["extend_subspace"]["calls"]
        spmv = report["matvecs"] + extends
        unconverged = sum("did not converge" in str(w.message)
                          for w in caught)
        print(f"[slice {prec}] n={op32.n} sigma={sigma:.6f} nearest Ritz "
              f"{ev[k]:.8f} exact {exact:.8f} rel err {rel:.2e} "
              f"(tol {EV_RTOL[prec]:.0e}); ||Hv-lv||/||H|| {res:.2e} (tol "
              f"{RES_TOL:.0e}); converged {status['isConverged']} after "
              f"{status['cumIter']} Krylov steps, {status['restarts']} "
              f"restarts; {report['solves']} solves, {report['iterations']} "
              f"MINRES iterations ({unconverged} solves above tolerance); "
              f"{spmv} SpMV = {report['matvecs']} in solves + {extends} "
              f"extends; {kname} launches {counts[kname]}; wall {wall:.2f} s, "
              f"{wall / spmv * 1e3:.4f} ms/SpMV, "
              f"{wall / report['iterations'] * 1e3:.4f} ms/MINRES iteration; "
              f"SpMV kernel share of wall (launches x phase-3 kernel time) "
              f"{counts[kname] * results[kcase]['ms'] / 1e3 / wall:.3f}",
              flush=True)
        print(f"[slice {prec}] phase seconds: " + ", ".join(
            f"{p} {t['seconds']:.2f} ({t['calls']})"
            for p, t in status["timers"].items()), flush=True)
        require(rel <= EV_RTOL[prec], f"{prec}: eigenvalue rel err {rel:.2e}")
        require(res <= RES_TOL, f"{prec}: residual {res:.2e}")
        require(counts[kname] > 0 and counts[kname] == spmv,
                f"{prec}: {kname} launched {counts[kname]} times, the "
                f"solves and extends report {spmv} SpMVs")
    print(f"[slice] peak device memory {peak_gb:.3f} GB; host read of one "
          f"device scalar {host_read_us:.1f} us (one per MINRES iteration)",
          flush=True)

    # -- 5. results ---------------------------------------------------------
    src = "eigensolvers_tpu_torch/csrc/bsr_spmv.cu"
    line = {"kernels": [
        dict(name="bsr_spmv", route="cuda", source=src,
             replaces="eigensolvers_tpu/ops/sparse.py:440",
             launches=counts["bsr_spmv"],
             max_abs_err=results["bsr_spmv f32"]["max_abs_err"],
             ms=results["bsr_spmv f32"]["ms"],
             plain_ms=results["bsr_spmv f32"]["plain_ms"]),
        dict(name="bsr_spmv_split", route="cuda", source=src,
             replaces="eigensolvers_tpu/ops/sparse.py:479",
             launches=counts["bsr_spmv_split"],
             max_abs_err=results["bsr_spmv_split"]["max_abs_err"],
             ms=results["bsr_spmv_split"]["ms"],
             plain_ms=results["bsr_spmv_split"]["plain_ms"]),
    ]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
