"""The slice operator of ``chip_smoke.py`` and the yardstick its kernel
times are read against, shared by ``chip_smoke.py`` and
:mod:`eigensolvers_tpu_torch.tools.bench_spmm`: the operator's parameters,
the card's rates, CUDA-event timing, the profiler's device time and the
host time of a launch, the bound of one product, the library yardstick,
and the bf16x3 kernels' bounds against the exact split product."""

from __future__ import annotations

import time

import numpy as np
import torch

from ..models import product

# A 2-mode vibrational Hamiltonian (see models/product.py): a quartic
# oscillator in 2048 HO functions (bandwidth 4) times a 128-point sinc DVR;
# n = 262,144, dataT (2048, 9, 128, 128).
M_OUT, B_IN, BANDWIDTH = 2048, 128, 4
OMEGA_OUT, LAM, OMEGA_IN, X_RANGE = 1.0, 1e-3, 1.3, (-7.0, 7.0)
# The card's rates for the bound (NVIDIA's H100 SXM data sheet, dense, at
# the 700 W limit): HBM bytes/s and the fastest unit's peak flop/s by type
# (the least time the card could take): f32 on the CUDA cores, f64 on the
# FP64 tensor cores (67 TFLOP/s; its CUDA cores give 34), bf16 on the
# tensor cores.
HBM_BPS = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "f64": 67e12, "bf16": 989e12}


def slice_factors():
    """The slice operator's outer and inner factors (H_out, h_in)."""
    return (product.anharmonic_oscillator_fbr(M_OUT, OMEGA_OUT, LAM),
            product.sinc_dvr_oscillator(B_IN, OMEGA_IN, X_RANGE))


def time_ms(fn, reps=30, warmup=3):
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


def device_ms(fn, reps=30, tries=3):
    """The device time in ms of the CUDA kernels that one call of ``fn``
    runs (the kernels' own time, without the launch gap that an event time
    counts), over ``reps`` calls under torch.profiler: the median kernel
    time where each call runs one kernel, else the mean per call.  A
    profile whose kernel count is not a multiple of ``reps`` missed some
    (the profiler does, late in a long process) and is taken again, up to
    ``tries`` times; None if none is whole."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = [e.device_time_total for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if times and len(times) % reps == 0:
            return float(np.median(times) if len(times) == reps
                         else sum(times) / reps) / 1e3
    return None


def host_us(fn, calls=200):
    """The host time in us of one call of ``fn`` that launches work on the
    card: ``calls`` calls back to back, without waiting for the card (the
    queue takes them), over the host clock.  Of the gap between an event
    time and the kernel's device time, this is the part spent in Python
    and the launch call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return t


def sparse_bsr(dataT, idx, ncols):
    """The library yardstick of the stored blocks: a
    ``torch.sparse_bsr_tensor`` of the nrb block rows (ELL padding
    included, the bytes the kernels read) by ``ncols`` columns, for ``A @
    x``; the port never calls it."""
    nrb, nbpr, B, _ = dataT.shape
    crow = torch.arange(0, nrb * nbpr + 1, nbpr, dtype=torch.int32,
                        device=dataT.device)
    vals = dataT.transpose(-1, -2).reshape(nrb * nbpr, B, B).contiguous()
    return torch.sparse_bsr_tensor(crow, idx.reshape(-1).contiguous(), vals,
                                   size=(nrb * B, ncols),
                                   check_invariants=False)


def bound(block_bytes, idx_bytes, m, npad, itemsize, flops, peak,
          npad_out=None):
    """The least time of one product, in ms, and what sets it: each input
    byte read once and each output byte written once over the HBM rate,
    against the flops over the peak rate of their type.  ``npad``: the
    length of each x lane; ``npad_out``: of each y lane (a row block's
    rows; default ``npad``)."""
    rows = npad if npad_out is None else npad_out
    t_bytes = (block_bytes + idx_bytes
               + m * (npad + rows) * itemsize) / HBM_BPS
    t_ops = flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# The bf16x3 ("high") kernels against the exact split product (the same
# bf16 products summed in f64): their f32 summation order alone, which
# grows with the N = nbpr * B terms of a row, bounded by 2e-6 of max |y| up
# to N = 1152 (the slice's; a true-f32 product reads 3.5e-6 and more there)
# and by 5e-6 beyond (at N = 2048 the roundoff itself reaches 3.5e-6); and
# their signature (see ``signature``) within 0.1 of 0, where a true-f32
# product reads 1 +- 0.1.
SPLIT_TOL, SPLIT_TOL_LONG, SIGNATURE_TOL = 2e-6, 5e-6, 0.1


def split_tol(nbpr, B):
    """The split kernels' bound against the exact split product."""
    return SPLIT_TOL if nbpr * B <= 1152 else SPLIT_TOL_LONG


def signature(y, exact, y64):
    """t = <y - exact, d> / <d, d> with d = y64 - exact, the split's own
    error: the share of it that y carries, ~0 for a bf16x3 product (its
    roundoff does not align with d) and ~1 for a true-f32 product."""
    d = y64.double() - exact.double()
    return float(((y.double() - exact.double()) * d).sum() / (d * d).sum())
