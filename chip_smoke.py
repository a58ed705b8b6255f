#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``eigensolvers_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device: requires CUDA (no CPU fallback), prints the card's name and
   power limit, sets and checks TF32 off;
2. build: compiles the block-ELL kernels from ``csrc/`` with nvcc, one
   process per source, and the checkpoint writer with g++, all started
   together;
3. kernels vs plain PyTorch on the card, at the slice shape and at ragged
   small shapes, with errors and CUDA-event timings: the single-vector SpMV
   (B1 ``bsr_spmv``, the ``bsr_spmm`` kernel launched with one vector; B2
   ``bsr_spmv_split``) and the multi-vector product
   (B3 ``bsr_spmm``, ``bsr_spmm_split``) for m = 1, 2, 4, 6, 8, 12, 16,
   32, 48, run (f)'s 64 vectors, and 96 and 128 (FEAST with m0 12 and 16
   at nc 8), and across the kernels' tiles and lane chunks (``bsr_spmm``
   reads the blocks once for up to 16 lanes on the CUDA cores and for up
   to 64 on the FP64 tensor cores from 17 lanes on, in f64 and f32, and
   runs more as chunks of 64; ``bsr_spmm_split`` runs ``mma.sync`` tiles
   up to 32 lanes and ``wgmma`` from 33, reads them once for up to 128
   lanes and runs more as chunks of equal width side by side; B2 is the
   tensor-core ``bsr_spmm_split`` launched with m = 1); the bf16x3 kernels
   against the exact split product, with a signature that tells them from
   a true-f32 product.  Beside each time: its bound (the larger of the
   bytes over the HBM rate and the flops over the peak rate of their type,
   f64 at its tensor cores' rate) and, for the f32/f64 products, the time
   of the one PyTorch call that computes the same function (a
   ``torch.sparse_bsr_tensor`` product, a yardstick the port never calls;
   the profiler names its kernel); for B1 also the profiler's device time
   of its kernel, so that the event time splits into it and the launch gap;
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
   - (e) ``fastLanczosDiagonalization`` with nBlock = 16 at "highest": the
     16 levels nearest sigma, every MINRES pass one 16-lane B3 apply;
   - (f) ``feastDiagonalization`` on a window of six levels around sigma,
     f32 solves at "highest" with the split-complex default and the fused
     loop: every MINRES pass one B3 apply of all 2 nk m0 real lanes; every
     exact level in the window found, with its f64 residual; then the
     share of a pass the card is busy, from ``torch.profiler``;
   - (t) the same FEAST run at "high": every MINRES pass one
     ``bsr_spmm_split`` launch of the 64 real lanes (the bf16x3 tensor-core
     kernel), one f64 B3 apply of the m0 vectors per outer iteration; the
     window's levels within "high"'s tolerance and (f)'s residual gate,
     compared with (f) (passes, iterations, levels), and one pass under
     ``torch.profiler``;
   - (g) bench.py's FEAST window task (n = 2048, dense, f32, cuBLAS) with
     the bench's own 1e-4 oracle;
   - (h0) the sum-of-products contraction kernel
     (``csrc/sop_contract.cu``) at the benchmark cell's shapes (n = 17^6
     in f64, modes 0, 3 and 5, 14 terms on one lane and 4 on three): its
     fan-out, middle and fan-in against the plain version, timed beside
     their byte bound; then its pair role on one lane and three (modes 1
     and 3 with five terms, 0 and 5 at post = 1, 0 and 2 with slots),
     beside its bound;
   - (h) the CH3CN 6-mode cut (``ch3cn_operator(N=14, nModesCut=6)``,
     n = 7,529,536): the grouped sum-of-products apply in f64 and f32,
     fused at 256 and unfused, timed and held against a numpy apply of the
     same groups on the host, then inexact Lanczos in f64 below the bottom
     of the spectrum for the 3 lowest levels, with their f64 residuals;
   - (i) bench.py's Chebyshev window task (``bench_chebyshev``: (g)'s
     matrix, window and guesses, f32, cuBLAS) with the bench's oracle;
   - (j) ``chebyshevFilteredDiagonalization`` on (f)'s window of the
     slice: f32 filter, every step one B3 launch of the m0 lanes, the
     adaptive degree (clipped), f64 Rayleigh-Ritz, enrichment and
     certificate; (f)'s gates, and launch counts from the attempts'
     degrees and rounds;
   - (k) spectrum slicing over (f)'s window on the f64 operator: the KPM
     moments (gated by the exact window counts), then
     ``spectrumSlicingDiagonalization`` with two windows, (f)'s solve
     options and the polish; every level found once, (f)'s gates;
   - (l) the N = 8 rung of the CH3CN tree ladder through the ported
     driver (``eigensolvers_tpu_torch.examples.ch3cn_excited_production``
     ``.run``) on the card: the tree operator and its TTNO, tree DMRG for
     the ground state and the nu8 pair, then block inexact Lanczos with
     tree-ALS solves at zpve + 360 cm-1, held to the JAX package's records
     (artifacts/ch3cn_production.jsonl);
   - (m) the N = 12 rung seeded from (l)'s states (``seed_rung=8``) by
     exact embedding, with every iteration checkpointed through the native
     writer (``csrc/fastio.cpp``, built with g++) and read back; peak
     device memory, host reads, and the card's times of one applyOp and
     one tree_als_solve (``tools/tree_device_host.py`` sets them beside
     the CPU's);
   - (n0) row-block launches on the slice operator: B1 f32 and f64, B2,
     B3 f32 at m = 2, 16, 64 and B3 f64 at m = 48 on 4 ranges of 512 block
     rows with the whole x, each bitwise equal to the matching rows of the
     square launch and held to its plain rectangular version; one range
     timed beside its bound, B1's also by the profiler's device time of its
     kernel; the square B1 (f32, f64) and B3 (m = 2, 64) re-timed beside
     the times PERF.md's kernel table records;
   - (n) the sharded backend (``eigensolvers_tpu_torch.parallel``) on
     NCCL, one process of world size 1 (the group joined here through a
     file store in a temporary directory): (n1) the single-vector
     "highest" Lanczos and (n2) the fused driver with nBlock 2 through
     ``shard_operator`` and ``ShardedVector``, each with the Krylov steps,
     MINRES iterations and (within 1e-10) levels of its unsharded run
     above, the same gates, the launches, and the collectives per step;
   - (p) the port's entry points (``graft_entry``): ``entry()``'s fused
     step, ``dryrun_multichip(1)``, and ``weak_scaling(1)``'s collective
     counts, held to the counts the CPU tests pin at 2 and 4 gloo ranks;
   - (q) the ported example drivers (``eigensolvers_tpu_torch.examples``)
     through their ``run``: the dense and tensor-network demos at their own
     defaults (driver_dense also ``--large``; spectrum slicing at n =
     100), the CH3CN drivers at cut arguments, each held to its own
     oracle, with no BSR kernel launched;
   - (r) the flagship at the production basis: the N = 42 rung of the
     excited ladder seeded from the committed N = 24 states
     (``seed_rung=24``), checkpointed through the native writer, converged
     and held to artifacts/ch3cn_production.jsonl:17 within 0.01 cm-1,
     with its distance to both sources of ROADMAP C.1, its wall, peak
     device memory and host reads;
   - (s) the last example drivers and the FEAST-filter tool, each through
     its ``run``, with wall, peak device memory and host reads: (s1) the
     chain maxD ladder at the production basis (N = 42, 12 modes, maxD 10
     -> 16) seeded from the committed N = 42 state, each rung held to its
     record within 0.01 cm-1; (s2) the DVR representation check at N = 42
     from the committed FBR state (the record's collapse below 0
     reproduced), then both representations at N = 14, held to the JAX
     package's values;
     (s3) the 2-mode study (dense f64 eigvalsh on the card up to the N =
     80 oracle, then the 4-mode DMRG rows at N = 42) held to its record;
     (s4) the FEAST-filter diagnosis on the N = 8 tree (complex ALS
     contour solves), every number finite; no BSR kernel launched;
5. a JSON line of per-kernel results, the ``nvidia-smi`` name/power line,
   and a final JSON status line.
"""

import collections
import contextlib
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
try:
    from eigensolvers_tpu_torch import (TorchVector, calculateTarget,
                                        chebyshevFilteredDiagonalization,
                                        feastDiagonalization,
                                        inexactLanczosDiagonalization,
                                        select_within_range,
                                        spectrumSlicingDiagonalization)
    from eigensolvers_tpu_torch import graft_entry
    from eigensolvers_tpu_torch.models import product
    from eigensolvers_tpu_torch.io import fastwriter
    from eigensolvers_tpu_torch.models.molecules import ch3cn_operator
    from eigensolvers_tpu_torch.models.synthetic import known_spectrum_matrix
    from eigensolvers_tpu_torch.ops import kernels, operators as sop_ops
    from eigensolvers_tpu_torch.ops import sparse as bsr
    from eigensolvers_tpu_torch.ops.linear_solvers import gmres_splitc_batch
    from eigensolvers_tpu_torch.ops.operators import DenseOperator
    from eigensolvers_tpu_torch.parallel import (ShardedVector,
                                                 collective_counts,
                                                 make_mesh,
                                                 reset_collective_counts,
                                                 shard_operator)
    from eigensolvers_tpu_torch.solvers.fast_lanczos import \
        fastLanczosDiagonalization
    from eigensolvers_tpu_torch.solvers import chebyshev as cheb
    from eigensolvers_tpu_torch.solvers.feast import _contour
    from eigensolvers_tpu_torch.solvers.slicing import (
        chebyshev_moments, window_count_from_moments)
    from eigensolvers_tpu_torch.tools.profile_passes import \
        profile as profile_passes
    from eigensolvers_tpu_torch.utils import checkpointing
    from eigensolvers_tpu_torch.utils.units import au2unit, unit2au
    from eigensolvers_tpu_torch.vectors.mps import (host_reads,
                                                    reset_host_reads)
    from eigensolvers_tpu_torch.vectors.ttns import TTNSVector
    from eigensolvers_tpu_torch.vectors.ttns_sweeps import tree_als_solve
    from eigensolvers_tpu_torch import examples
    from eigensolvers_tpu_torch.examples import (
        ch3cn_excited_production as excited_production)
    # the slice's operator (n = 262,144; nbpr = 9), the card's rates, the
    # timing and the bound, shared with tools/bench_spmm.py
    from eigensolvers_tpu_torch.tools.yardstick import (
        B_IN, BANDWIDTH, HBM_BPS, M_OUT, PEAK_FLOPS, SIGNATURE_TOL, SPLIT_TOL,
        SPLIT_TOL_LONG, X_RANGE, bound, device_ms, host_us, signature,
        slice_factors, sparse_bsr, split_tol, time_ms)
except ImportError as e:
    raise SystemExit(f"chip_smoke: the eigensolvers_tpu_torch package is "
                     f"not beside this script ({e})")

TARGET_LEVEL = 20                              # sigma between levels 20 and 21
LANCZOS = dict(L=12, maxit=8, eConv=1e-7, checkFitTol=1e-5)
LINEAR = dict(linearSolver="minres", linearIter=20000, linear_tol=1e-2,
              linear_atol=1e-2, preconditioner="jacobi",
              errorOnNonConvergence=False)
NBLOCK = 2
NBLOCK_WIDE = 16                               # run (e)
# run (f): FEAST on the window whose edges lie halfway between levels
# 17|18 and 23|24 (the six levels 18..23 around sigma); m0 = 8 takes the two
# nearest outside levels too, so no guess vector is left to the solve noise.
# Most J-symmetrized lanes need more than 3,000 MINRES iterations to reach
# even 1e-2 here, so, as bench.py's FEAST task does, each solve is capped
# (linearIter 2,500, no escalation rounds): inexact FEAST with the f64
# carry converges through them, and 8 outer iterations bring every level
# within the gates (~60 s on the H100, PERF.md)
FEAST_LEVELS = (18, 23)
FEAST = dict(nc=8, m0=8, eConv=1e-6, maxit=8, npackets=8)
FEAST_LINEAR = dict(linearSolver="minres", linearIter=2500, linear_tol=1e-3,
                    linear_atol=1e-5, preconditioner="jacobi",
                    errorOnNonConvergence=False, escalateIter=0)
F_LANES = 2 * (FEAST["nc"] // 2) * FEAST["m0"]  # real lanes of one pass
# B3 at the slice shape: the main path's lane counts ((j)'s m0 = 12, the
# 48 of (k)'s FEAST windows, the 6 of (k)'s polish) among them, and the
# 96 and 128 lanes of FEAST with m0 12 and 16 at nc 8
LANES = (1, 2, 4, 6, 8, 12, 16, 32, 48, F_LANES, 96, 128)
# B3's route by lane count (csrc/bsr_spmm.cu: the FP64 tensor cores from
# 17 lanes on, f32 widened to f64 there), and the split kernel's
# (csrc/bsr_spmm_split.cu: wgmma from 33 lanes on at the slice's shape,
# mma.sync below)
MMA_FROM = 17
SPLIT_WG_FROM = 33
# run (g): bench.py's FEAST window task (bench_feast) and its oracle
FEAST_BENCH = dict(n=2048, eMin=1000.25, eMax=1004.75, m0=10, nc=8,
                   eConv=1e-6, maxit=8, oracle=1e-4)
FEAST_BENCH_LINEAR = {"linearSolver": "minres", "linearIter": 2500,
                      "linear_tol": 1e-5, "errorOnNonConvergence": False,
                      "escalateIter": 0}
# run (i): bench.py's Chebyshev window task (bench_chebyshev): run (g)'s
# matrix, window and guesses, f32, the adaptive degree, specBounds from the
# spectrum, eConv 1e-6, 30 outer iterations, the bench's 1e-4 oracle
CHEB_BENCH = dict(eConv=1e-6, maxit=30, oracle=1e-4)
# run (j): the Chebyshev window on the slice: (f)'s window, the adaptive
# degree (3.5 x span / width = 64,948 here, clipped to 8,000), m0 = 12 low
# guesses, the spectrum's bounds padded by 1 (bench_chebyshev's padding;
# the entry point's own estimate, which the run also takes and prints,
# lies ~4,600 below the bottom and leaves the window unresolved at this
# degree), the fused loop; (f)'s gates
CHEB_SLICE = dict(m0=12, eConv=1e-6, maxit=8, npackets=8,
                  dtype=torch.float32)
# run (k): spectrum slicing over (f)'s window on the f64 slice operator, on
# (j)'s bounds: KPM moments of degree 2,000 from 8 probes (gated: each
# window count within max(2, 30 %) of the exact count), then two
# load-balanced FEAST windows with (f)'s solve options but MINRES capped at
# 1,500 iterations (at (f)'s 2,500 the run was a fifth of the script's
# wall; capped, the first window ends unconverged after its 8 iterations
# and the polish certifies every level), (f)'s 8 outer iterations, and one
# polish round; (f)'s gates, each level found once.  With 4 outer
# iterations unconverged Ritz pairs polished onto the same states and half
# the levels were dropped as duplicates; a second polish round solves a
# system singular to machine precision at the first round's Rayleigh
# quotient, and the Jacobi-preconditioned MINRES then moves the pairs off
# their states (PERF.md §6)
SLICING = dict(degree=2000, nProbes=8, seed=0, nWindows=2, maxit=8,
               polish_rounds=1, eConv=1e-6, count_rtol=0.3, count_atol=2,
               linearIter=1500)
# run (h): the CH3CN 6-mode cut of bench.py's bench_sop; the apply's gates
# are the bench's: f32 within 3x the numpy f32 error floor (+1e-10), f64
# within 1e-10 of max |y| of the numpy f64 apply (summation order).  The
# Lanczos run: f64 on the faster f64 form, sigma 500 cm-1 below the
# harmonic zero-point energy, a block of three guesses (the ground product
# state and the fundamentals of the two softest modes, x4 and x3) for the
# 3 lowest levels.
CH3CN = dict(N=14, cut=6, fuse=256, guesses=((), (3,), (2,)))
CH3CN_LANCZOS = dict(L=8, maxit=3, eConv=1e-9, checkFitTol=1e-5)
CH3CN_LINEAR = dict(linearSolver="minres", linearIter=4000, linear_tol=1e-4,
                    linear_atol=1e-8, preconditioner="jacobi",
                    errorOnNonConvergence=False)
# runs (l), (m): the CH3CN tree ladder through the ported excited driver
# (eigensolvers_tpu_torch/examples/ch3cn_excited_production.py): N = 8,
# then N = 12 seeded from (l)'s states (--seed-rung 8), the parameters of
# its records in artifacts/ch3cn_production.jsonl (lines 13 and 14), the
# rung zero-point energies the excited driver reads (lines 3 and 10).
# The gates: each block eigenvalue within 0.01 cm-1 of the record, the reported
# residual (1e-6 at N = 8, 1e-7 at N = 12; records 4.4e-8 and 3.5e-9).  The
# N = 8 DMRG zpve is held to 9837.5207: the JAX package and this one, run
# on the CPU with these parameters, both give 9837.52066; the record's
# 9837.5615 (line 3) is a maxD 6 Lanczos value, 0.041 cm-1 above.
TREE_L = dict(N=8, params=dict(maxD=8, L=4, maxit=2, eConv=1e-4, nBlock=2,
                               nSweep=2),
              zpve=9837.5615, ev=(10198.576, 10198.5879), res=1e-6,
              dmrg_zpve=9837.5207)
TREE_M = dict(N=12, params=dict(maxD=10, L=10, maxit=20, eConv=1e-6,
                                nBlock=2, nSweep=2),
              zpve=9837.4519, ev=(10198.4882, 10198.4987), res=1e-7)
TREE_EV_TOL_CM = 0.01
# run (r): the flagship at the production basis, N = 42 (fused leaves of
# 1,764), seeded from the committed N = 24 states (--seed-rung 24) as the
# JAX record was, at that record's parameters (jsonl line 17), sigma =
# zpve + 360 cm-1 with line 12's zpve; gates: converged, residual 1e-6,
# both levels within 0.01 cm-1 of line 17.  The two committed sources of
# ROADMAP C.1, whose distance (r) prints:
FLAGSHIP = dict(N=42, seed_rung=24, params=TREE_M["params"], zpve=9837.4691,
                ev=(10198.4884, 10198.4987), res=1e-6)
FLAGSHIP_SOURCES = {
    "artifacts/ch3cn_production.jsonl:17": (10198.4884, 10198.4987),
    "artifacts/summary_ch3cn_excited_N42.out": (10198.4436, 10198.4539)}
# run (q): the ported example drivers on the card.  Examples 1 and 4-10
# at their own defaults (and driver_dense --large), but spectrum slicing:
# its n = 400 (60 levels in 200.25..320.25) took 156 s and 301 s on two
# H100 machines, which brought the whole script to 1,148 s of its 1,200,
# so it runs the same matrix family and spacing at n = 100 (15 levels in
# 50.25..80.25).  11-16 cut to fit the phase in ~150 s: tree FEAST at
# N = 8 (line 3's zpve) with 4 nodes, 2 outer iterations and 2 sweeps per
# solve (4 sweeps move the pair by 0.0006 / 0.0010 cm-1, to 362.0353 /
# 362.0363); the chain DMRG at N = 12, maxD 6 (run_clean -full's
# arguments); the block Lanczos at N = 8, L 4, maxit 2; chain FEAST on 4
# modes at bond 8 (its default, 5 modes at bond 16, took 56 s on the
# card); the chain ladder's N = 14 rung seeded from the committed
# artifacts/ch3cn_state_N14.npz (--seed-rung 14); the targeted Lanczos
# with its guess at N = 6 and its basis at N = 8, bond 8 (zpve
# 9837.5687; its defaults, 8 / 12 / 10, give 9837.4818 in 1.7x the
# wall).  Each example's own oracle is a gate:
EX_TOL = dict(
    dense=1e-6,        # driver_dense: the nearest exact level, relative
    feast=1e-6,        # feast_window: every exact window level, relative
    cheb=1e-8,         # chebyshev_window (eConv 1e-10)
    slicing=1e-8,      # spectrum_slicing: max |ev err|, every level found
    follow=1e-8,       # state_following_ho (eConv 1e-10), relative
    pyrazine=1e-6,     # pyrazine_vibronic (eConv 1e-8), relative
    mps=1e-6,          # mps_sop_lanczos: the dense oracle, relative
    # (ttns_tree_lanczos raises itself beyond 1e-5 of its dense oracle)
    # the CH3CN drivers, in cm-1: tree FEAST's pair at bond 3 against (l)'s
    # (the JAX package's N = 12 FEAST record sits 1.05 cm-1 above its
    # Lanczos pair), chain FEAST against its DMRG levels, the chain zpves
    # against the committed chain N = 14 record (line 1: 9837.4818), the
    # block pair against the tree N = 8 record's (line 13)
    # (the level nearest the 360 cm-1 target)
    tree_feast_cm=2.0, chain_feast_cm=0.01, dmrg_cm=1.0, targeted_cm=0.2,
    block_cm=1.0, ladder_cm=0.01)
TREE_TARGET_CM = 360.0
CHAIN_N14_CM = 9837.4818                      # jsonl line 1
# run (s): the last example drivers and the FEAST-filter tool.  (s1) the
# chain maxD ladder at the production basis (N = 42, all 12 modes, rungs
# 10 -> 16, 8 sweeps each) seeded from the committed
# artifacts/ch3cn_state_N42.npz: each rung within 0.01 cm-1 of its record
# (jsonl lines 5-8, 9837.4792 at every rung).
LADDER = dict(Ds=(10, 12, 14, 16), N=42, nSweep=8, zpve=9837.4792, tol=0.01)
# (s2) the representation check at full width (N = 42, DVR, maxD 10, 12
# sweeps from the committed FBR state): the collapse of the JAX record
# (jsonl line 9, -551,362.872 cm-1) reproduced, i.e. a ZPVE below 0; its
# distance to the record is printed, not gated (a DMRG run into the PES
# turnover follows roundoff).  Then at N = 14, maxD 10, 4 sweeps, seeded
# from the committed artifacts/ch3cn_state_N14.npz, both representations,
# each held within 1e-6 relative of the JAX package's value at the same
# size (its dmrg_eigensolve with these arguments, run on the CPU with jax
# 0.9 and scipy 1.17; with the script's 12 sweeps the DVR reads
# 9837.478188412291):
REP_COLLAPSE_CM = -551362.872
REP_CHECK = dict(N=14, maxD=10, nSweep=4, rtol=1e-6,
                 zpve={"dvr": 9837.478898056208, "fbr": 9837.482799178808})
# (s3) the 2-mode study (jsonl line 21): the N = 80 oracle and every
# FBR/DVR row at N = 14 / 28 / 42 within 1e-5 cm-1 of 2673.794874, none
# collapsed; the 4-mode FBR and DVR DMRG rows within 1e-4 cm-1 of
# 3832.145829.  Its 6-mode row (115 s at maxD 24, 216 s at maxD 32 on an
# NVIDIA H100 80GB HBM3, 700 W) runs alone: python3 -m
# eigensolvers_tpu_torch.examples.ch3cn_representation_2mode.
REP_2MODE = dict(zpve=2673.794874, dense_tol=1e-5, mode_cuts=(4,),
                 four_mode=3832.145829, dmrg_tol=1e-4)
# (s4) the FEAST-filter diagnosis on the N = 8 tree: every residual and
# Rayleigh quotient finite
DIAG_N = 8
SLICING_EX = dict(n=100, interval=(50.25, 80.25))
# run (n0): the slice operator's 2048 block rows in 4 ranges of 512, each
# launched with the whole x; the square B1 / B3 times that PERF.md's
# kernel table records (section 6, NVIDIA H100 80GB HBM3, 700.00 W)
# beside this run's
ROW_RANGES = 4
RECORDED_MS = {("bsr_spmv f32", 1): 0.4000, ("bsr_spmv f64", 1): 0.7815,
               ("bsr_spmm f32", 2): 0.4328, ("bsr_spmm f32", 64): 0.7769}
# run (n): the sharded levels against the unsharded run's (the same
# arithmetic with one rank: all-reduces and all-gathers of one rank copy)
SHARDED_RTOL = 1e-10


NO_LIBRARY = ("none: no single PyTorch call computes the bf16x3 product "
              "(x split per element, three bf16 products, xl*lo dropped)")
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
KERNEL_TOL = {"f64": 1e-12, "f32": 1e-5, "split": SPLIT_TOL,
              "split_long": SPLIT_TOL_LONG, "split_f64": 1e-5,
              "split_lanes": 2e-5, "signature": SIGNATURE_TOL}


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


NOT_MEASURED = "not measured (the profiler recorded no whole set of kernels)"


def ms_or_none(ms):
    return f"{ms:.4f} ms" if ms is not None else NOT_MEASURED


def relerr(y, ref):
    return float((y.double() - ref.double()).abs().max()
                 / ref.double().abs().max())


@contextlib.contextmanager
def recording_calls():
    """Record (kernel, lanes, dtype) of every B1 / B3 f32-f64 product call
    and every bf16x3 lane-stack call while the block is open, by wrapping
    the wrappers in ``ops.sparse``."""
    calls = []
    b1, b3, b3s = bsr.bsr_matvec, bsr.bsr_matmat, bsr.bsr_matmat_split

    def rec_b1(dataT, idx, xp):
        calls.append(("bsr_spmv", 1, xp.dtype))
        return b1(dataT, idx, xp)

    def rec_b3(dataT, idx, Xp):
        calls.append(("bsr_spmm", Xp.shape[0], Xp.dtype))
        return b3(dataT, idx, Xp)

    def rec_b3s(hiT, loT, idx, Xp):
        calls.append(("bsr_spmm_split", Xp.shape[0], Xp.dtype))
        return b3s(hiT, loT, idx, Xp)

    bsr.bsr_matvec, bsr.bsr_matmat, bsr.bsr_matmat_split = (rec_b1, rec_b3,
                                                            rec_b3s)
    try:
        yield calls
    finally:
        bsr.bsr_matvec, bsr.bsr_matmat, bsr.bsr_matmat_split = b1, b3, b3s


def count_calls(calls, kernel, lanes=None, dtype=None):
    return sum(1 for k, m, dt in calls if k == kernel
               and lanes in (None, m) and dtype in (None, dt))


def units(name, m):
    """The units a kernel runs m lanes on (B3: csrc/bsr_spmm.cu's route)."""
    if "split" in name:
        return ("bf16 tensor cores, "
                + ("wgmma" if m >= SPLIT_WG_FROM else "mma.sync"))
    return ("FP64 tensor cores" if name.startswith("bsr_spmm") and m >= MMA_FROM
            else "CUDA cores")


def b3_seconds(calls, results):
    """The seconds the recorded B3 f32/f64 calls take at phase 3's times of
    their lane counts, and the (dtype, lanes) that phase 3 did not time."""
    total, missing = 0.0, set()
    for k, m, dt in calls:
        key = (f"bsr_spmm {'f32' if dt == torch.float32 else 'f64'}", m)
        if k == "bsr_spmm" and key in results:
            total += results[key]["ms"] / 1e3
        elif k == "bsr_spmm":
            missing.add(key)
    return total, missing


def filter_rates(lam, a, b, degree, e_min, e_max, m0s=(8, 12, 16)):
    """The window filter's per-round convergence rate |p(l_(m0+1))| /
    min over the window of |p| for each m0, on the exact spectrum ``lam``
    (the levels below 200 and every 997th above), with [a, b] padded as
    the entry point pads it."""
    pad = 1e-3 * (b - a)
    a, b = min(a, e_min - pad), max(b, e_max + pad)
    cf = cheb.chebyshev_window_coefficients(degree, a, b, e_min, e_max)
    x = np.concatenate([lam[lam < 200], lam[lam >= 200][::997]])
    p = np.abs(np.polynomial.chebyshev.chebval(
        (x - 0.5 * (a + b)) / (0.5 * (b - a)), cf))
    inside = (x >= e_min) & (x <= e_max)
    outside = np.sort(p[~inside])[::-1]
    return {m0: float(f"{outside[m0 - inside.sum()] / p[inside].min():.3g}")
            for m0 in m0s}


def np_sop_apply(groups, id_coeff, dims, x, dtype):
    """A grouped sum-of-products apply in numpy on the host, the oracle of
    run (h): per group, each active mode one batched matmul over the term
    axis, then the term sum (bench.py's np_apply, as matmuls)."""
    xt = np.asarray(x, dtype).reshape(dims)
    y = np.asarray(id_coeff, dtype) * xt
    for modes, facs in groups:
        S = facs[0].shape[0]
        xb = np.broadcast_to(xt, (S,) + tuple(dims))
        for mode, f in zip(modes, facs):
            pre = int(np.prod(dims[:mode]))
            post = int(np.prod(dims[mode + 1:]))
            f = f.astype(dtype)
            if post == 1:
                xb = np.matmul(xb.reshape(S, pre, dims[mode]),
                               f.transpose(0, 2, 1))
            else:
                xb = np.matmul(f[:, None],
                               xb.reshape(S, pre, dims[mode], post))
        y = y + xb.reshape((S,) + tuple(dims)).sum(axis=0)
    return y.reshape(-1)


def sop_kernel_roles(dev):
    """Run (h0): the three roles of the sum-of-products contraction kernel
    (``csrc/sop_contract.cu``) at the benchmark cell's shapes: n = 17^6 in
    f64 viewed about modes 0 (pre = 1), 3 and 5 (post = 1), 14 terms on one
    lane and 4 on three.  Each is held to ``sop_contract_plain`` (f64
    roundoff: 1e-12 of max |y|) and timed in turns (plain, kernel, kernel,
    plain; CUDA-event medians, 10 kernel runs, 3 plain) beside its bound:
    each input read once and each output written once at the HBM rate.
    Returns the results by (role, lanes, terms, mode)."""
    from eigensolvers_tpu_torch.ops import operators as sop
    N, k = 17, 6
    n = N ** k
    g = torch.Generator(device=dev).manual_seed(7)
    out = {}
    for m, S in ((1, 14), (3, 4)):
        F = torch.randn((S, N, N), generator=g, device=dev,
                        dtype=torch.float64) / N
        x = torch.randn((m, n), generator=g, device=dev, dtype=torch.float64)
        Z = torch.randn((S, m, n), generator=g, device=dev,
                        dtype=torch.float64)
        y = torch.randn_like(x)
        for mode in (0, 3, 5):
            pre, post = N ** mode, N ** (k - 1 - mode)
            for role, passes in (("fan-out", S + 1), ("middle", 2 * S),
                                 ("fan-in", S + 2)):
                def call(fn, Zc=Z, yc=y):
                    zs = [Zc[s] for s in range(S)]
                    if role == "fan-out":
                        fn(F, [x] * S, zs, pre, post)
                    elif role == "middle":
                        fn(F, zs, zs, pre, post)
                    else:
                        fn(F, zs, [yc], pre, post, True, True)
                    return Zc if role != "fan-in" else yc
                got = call(sop.sop_contract, Z.clone(), y.clone())
                want = call(sop.sop_contract_plain, Z.clone(), y.clone())
                err = relerr(got, want)
                del got, want
                require(np.isfinite(err) and err <= 1e-12,
                        f"(h0) sop_contract {role} error {err:.3e}")
                p1 = time_ms(lambda: call(sop.sop_contract_plain), reps=3,
                             warmup=1)
                k1 = time_ms(lambda: call(sop.sop_contract), reps=10)
                k2 = time_ms(lambda: call(sop.sop_contract), reps=10)
                p2 = time_ms(lambda: call(sop.sop_contract_plain), reps=3,
                             warmup=1)
                ms, plain_ms = min(k1, k2), min(p1, p2)
                bound_ms = passes * m * n * 8 / HBM_BPS * 1e3
                out[(role, m, S, mode)] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    max_rel_err=err)
                print(f"[sop kernel] {role} m={m} S={S} mode {mode} (pre "
                      f"{pre}, post {post}): rel err {err:.2e}; kernel "
                      f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                      f"{bound_ms:.4f} ms ({passes} passes of {m} x {n} f64 "
                      f"at {HBM_BPS / 1e12:.2f} TB/s; {bound_ms / ms:.0%} of "
                      f"it)", flush=True)
        del F, x, Z, y
    torch.cuda.empty_cache()
    return out


def sop_pair_role(dev):
    """Run (h0) for the pair role (``sop_pair``, ``csrc/sop_contract.cu``)
    at the benchmark cell's shapes: n = 17^6 in f64, on one lane and three,
    the cell's largest pair (modes 1 and 3, five terms summed into y), a
    pair on the last mode (0 and 5, post = 1, two terms) and one that also
    writes slots (0 and 2: three slots, three terms summed).  Each is held
    to ``sop_pair_plain`` (f64 roundoff: 1e-12 of max |y|) and timed in
    turns as ``sop_kernel_roles`` times the one-mode roles, beside its
    bound: the larger of x read once, y read and written once and each slot
    written once at the HBM rate, and the flops (2 (Na + Nb) an element a
    term) at the f64 peak.  Returns the results by (lanes, modes)."""
    from eigensolvers_tpu_torch.ops import operators as sop
    N, k = 17, 6
    n = N ** k
    g = torch.Generator(device=dev).manual_seed(11)
    out = {}
    for m in (1, 3):
        x = torch.randn((m, n), generator=g, device=dev, dtype=torch.float64)
        y = torch.randn_like(x)
        for a, b, S, nslot in ((1, 3, 5, 0), (0, 5, 2, 0), (0, 2, 6, 3)):
            pre, mid, post = N ** a, N ** (b - a - 1), N ** (k - 1 - b)
            A = torch.randn((S, N, N), generator=g, device=dev,
                            dtype=torch.float64) / N
            B = torch.randn((S, N, N), generator=g, device=dev,
                            dtype=torch.float64) / N
            Z = [torch.empty_like(x) for _ in range(nslot)]

            def call(fn, yc=y):
                fn(A, B, x, Z, yc, pre, mid, post, beta=True)
                return yc
            got = call(sop.sop_pair, y.clone())
            got_z = [z.clone() for z in Z]
            want = call(sop.sop_pair_plain, y.clone())
            err = max([relerr(got, want)]
                      + [relerr(zg, zw) for zg, zw in zip(got_z, Z)])
            del got, got_z, want
            require(np.isfinite(err) and err <= 1e-12,
                    f"(h0) sop_pair ({a}, {b}) error {err:.3e}")
            p1 = time_ms(lambda: call(sop.sop_pair_plain), reps=3, warmup=1)
            k1 = time_ms(lambda: call(sop.sop_pair), reps=10)
            k2 = time_ms(lambda: call(sop.sop_pair), reps=10)
            p2 = time_ms(lambda: call(sop.sop_pair_plain), reps=3, warmup=1)
            ms, plain_ms = min(k1, k2), min(p1, p2)
            passes = 3 + nslot
            bytes_ms = passes * m * n * 8 / HBM_BPS * 1e3
            flops_ms = S * 2 * 2 * N * m * n / PEAK_FLOPS["f64"] * 1e3
            bound_ms = max(bytes_ms, flops_ms)
            out[(m, (a, b))] = dict(ms=ms, plain_ms=plain_ms,
                                    bound_ms=bound_ms, bytes_ms=bytes_ms,
                                    flops_ms=flops_ms, terms=S, slots=nslot,
                                    max_rel_err=err)
            print(f"[sop pair] m={m} modes ({a}, {b}) S={S} slots {nslot} "
                  f"(pre {pre}, mid {mid}, post {post}): rel err {err:.2e}; "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{bound_ms:.4f} ms (bytes {bytes_ms:.4f}: {passes} passes "
                  f"of {m} x {n} f64 at {HBM_BPS / 1e12:.2f} TB/s; flops "
                  f"{flops_ms:.4f} at {PEAK_FLOPS['f64'] / 1e12:.0f} "
                  f"TFLOP/s; {bound_ms / ms:.0%} of it)", flush=True)
            del A, B, Z
        del x, y
    torch.cuda.empty_cache()
    return out


def kernel_names(fn):
    """The CUDA kernels one call of ``fn`` runs, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sorted({e.key for e in prof.key_averages()
                       if getattr(e, "device_time_total",
                                  getattr(e, "cuda_time_total", 0)) > 0})
    except Exception as e:                       # the profiler is a reading
        return [f"not measured ({type(e).__name__}: {e})"]


def device_times(fn):
    """The CUDA kernels one call of ``fn`` runs, with their device time,
    longest first (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [(getattr(e, "device_time_total", 0), e.key, e.count)
                for e in prof.key_averages()]
        return [f"{k[:60]} {t / 1e3:.2f} ms ({n})"
                for t, k, n in sorted(rows, reverse=True) if t > 0]
    except Exception as e:                       # the profiler is a reading
        return [f"not measured ({type(e).__name__}: {e})"]


def compare(name, kern, plain, ref, tol, gb, bound_ms, bound_by,
            library=None, device=False):
    """Hold a kernel against its plain version (or ``ref``) and time both in
    turns (plain, kernel, kernel, plain), then the library call, if any,
    twice, and with ``device`` the kernel's own device time (the profiler's;
    the event time less it is the launch gap); returns the result dict."""
    yk = kern()
    torch.cuda.synchronize()
    yp = plain() if ref is None else ref
    torch.cuda.synchronize()
    err = relerr(yk, yp)
    abs_err = float((yk.double() - yp.double()).abs().max())
    require(np.isfinite(err) and err <= tol,
            f"{name} relative error {err:.3e} > {tol:.0e}")
    del yk, yp
    ms_p1 = time_ms(plain)
    ms_k1 = time_ms(kern)
    ms_k2 = time_ms(kern)
    ms_p2 = time_ms(plain)
    ms_k, ms_p = min(ms_k1, ms_k2), min(ms_p1, ms_p2)
    lib_ms, lib_note = None, NO_LIBRARY
    if library is not None:
        lib_ms, lib_note = library()
    lib = f"{lib_ms:.4f} ms" if lib_ms is not None else lib_note
    dev_ms = device_ms(kern) if device else None
    host = host_us(kern) if device else None
    print(f"[kernel] {name}: rel err {err:.3e} (tol {tol:.0e}); kernel "
          f"{ms_k:.4f} ms ({gb / ms_k * 1e3:.0f} GB/s of block data), plain "
          f"{ms_p:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
          f"{bound_ms / ms_k:.0%} of it), library {lib}; medians of 30 "
          f"(kernel {ms_k1:.4f}/{ms_k2:.4f}, plain {ms_p1:.4f}/{ms_p2:.4f})"
          + ("; the kernel's device time "
             + (f"{dev_ms:.4f} ms (profiler), launch gap {ms_k - dev_ms:.4f} "
                f"ms" if dev_ms is not None else NOT_MEASURED)
             + f"; host time of one call {host:.1f} us" if device else ""),
          flush=True)
    return dict(max_rel_err=err, max_abs_err=abs_err, ms=ms_k, plain_ms=ms_p,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
                library=lib_note, device_ms=dev_ms, host_us=host)


def wall_ms(fn, reps, dev, warmup=True):
    """Median host-clock time of ``fn`` in ms, after one warm-up call if
    ``warmup``, each run ending in a synchronize when ``dev`` is the card
    (the tensor-network calls read the device to the host as they go, so
    their time is a host time)."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    if warmup:
        fn()
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def check_rung(tag, rung, want, res_tol):
    """Gates of one rung of the excited ladder, as its driver returns it:
    the block eigenvalues within TREE_EV_TOL_CM of ``want`` (cm-1), the
    reported residual within ``res_tol``, the Ritz states on the card and
    finite, and each one's <v|H|v> (the TTNO zipper) its eigenvalue.
    Prints the rung; returns the levels in cm-1."""
    rec, status = rung["record"], rung["status"]
    ev_cm = rec["ev_cm1"]
    op, topo = rung["op"], rung["topo"]
    W = op._ttno_cache[(topo, None)]
    rq_cm = [float(au2unit(np.real(W.sandwich(v.tensors, v.tensors)
                                   / v.vdot(v)), "cm-1"))
             for v in rung["vectors"]]
    res = rec["residual"]
    print(f"[tree {tag}] N={rec['N']} maxD {rec['maxD']} L {rec['L']} "
          f"nBlock {rec['nBlock']}: ev {', '.join(f'{e:.4f}' for e in ev_cm)}"
          f" cm-1 (want {', '.join(str(e) for e in want)}, tol "
          f"{TREE_EV_TOL_CM}), excitations {rec['excitation_cm1']} above "
          f"zpve {rec['zpve_cm1']}; <v|H|v> of the fitted states (zipper) "
          f"{', '.join(f'{e:.4f}' for e in sorted(rq_cm))}; residual "
          f"{res:.3e} (tol {res_tol:.0e}); converged {rec['converged']} "
          f"after {rec['cumIter']} Krylov steps; wall {rung['wall']:.2f} s;"
          f" state bonds "
          f"{[[int(t.shape[0]) for t in v.tensors[1:]]
               for v in rung['vectors']]}",
          flush=True)
    require(all(abs(a - b) <= TREE_EV_TOL_CM for a, b in zip(ev_cm, want)),
            f"{tag}: eigenvalues {ev_cm} cm-1, want {want}")
    require(res <= res_tol, f"{tag}: residual {res:.3e}")
    require(all(min(abs(r - e) for e in ev_cm) <= TREE_EV_TOL_CM
                for r in rq_cm),
            f"{tag}: <v|H|v> {rq_cm} of the returned states, ev {ev_cm}")
    require(all(t.is_cuda and bool(torch.isfinite(t).all())
                for v in rung["vectors"] for t in v.tensors),
            f"{tag}: Ritz states left the card or are not finite")
    return ev_cm


def ladder_rung(tag, dev, out, N, params, **kw):
    """One rung of the excited ladder through the ported driver
    (``examples.ch3cn_excited_production.run``), with its ALS solves
    counted and its host reads and peak device memory read."""
    report = {}
    reset_host_reads()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 1e9
    res = excited_production.run([N], device=dev, out=out, report=report,
                                 **params, **kw)
    [rung] = res["rungs"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"[tree {tag}] {report.get('solves', 0)} ALS solves; host reads "
          f"{dict(host_reads)}; peak device memory {peak:.3f} GB, "
          f"{peak - base:.3f} GB above the {base:.3f} GB allocated before "
          f"the run", flush=True)
    return rung, peak


def check_checkpoints(tag, d, topo, dev):
    """Every iteration's checkpoint went through the native writer and the
    last one reads back as the run's tree states."""
    tag_last = checkpointing.latest_tag(d)
    files = sorted(os.listdir(d))
    vecs, meta = checkpointing.load_checkpoint(d, tag_last, TTNSVector,
                                               device=dev)
    print(f"[tree {tag}] checkpoints: {len(files)} files on disk, last tag "
          f"{tag_last} holds {len(vecs)} tree states, status cumIter "
          f"{meta['status'].get('cumIter')}", flush=True)
    require(len(files) > 0 and tag_last is not None
            and meta["status"].get("cumIter") == tag_last
            and all(v.topo == topo and all(torch.isfinite(t).all()
                                           for t in v.tensors) for v in vecs),
            f"{tag} checkpoints: files {files}")
    return len(files)


def tree_ladder(dev, out):
    """Runs (l) and (m): the CH3CN tree ladder on the card, through the
    ported excited driver.  Returns the phase walls."""
    walls = {}
    # (l): N = 8: DMRG for the ground state and the nu8 pair, then the block
    # Lanczos on the pair
    rung, _ = ladder_rung("(l)", dev, os.path.join(out, "l"), TREE_L["N"],
                          TREE_L["params"])
    es_cm = rung["dmrg_cm1"]
    print(f"[tree (l)] CH3CN tree N={TREE_L['N']}: TTNO edge ranks "
          f"{rung['op']._ttno_cache[(rung['topo'], None)].ranks}; DMRG: "
          f"zpve {es_cm[0]:.4f} cm-1 (tol {TREE_EV_TOL_CM} of "
          f"{TREE_L['dmrg_zpve']}), excited guesses "
          f"{', '.join(f'{e - es_cm[0]:.4f}' for e in es_cm[1:])} cm-1 above "
          f"it; {rung['dmrg_s']:.2f} s", flush=True)
    require(abs(es_cm[0] - TREE_L["dmrg_zpve"]) <= TREE_EV_TOL_CM,
            f"(l) DMRG zpve {es_cm[0]:.4f}")
    require(rung["zpve_cm1"] == TREE_L["zpve"], f"(l) zpve {rung['zpve_cm1']}")
    check_rung("(l)", rung, TREE_L["ev"], TREE_L["res"])
    walls["(l) DMRG"], walls["(l) Lanczos"] = rung["dmrg_s"], rung["wall"]
    del rung

    # (m): N = 12 from (l)'s states (--seed-rung 8 from (l)'s output),
    # embedded exactly; checkpoints of every iteration through the native
    # writer
    writer = checkpointing.default_async_writer()
    require(writer is not None and writer.available,
            "(m) the native checkpoint writer was not built")
    submitted = writer.submitted
    rung, peak = ladder_rung("(m)", dev, os.path.join(out, "m"), TREE_M["N"],
                             TREE_M["params"], seed_rung=TREE_L["N"],
                             seed_dir=os.path.join(out, "l"),
                             checkpoint=True)
    require(rung["zpve_cm1"] == TREE_M["zpve"], f"(m) zpve {rung['zpve_cm1']}")
    check_rung("(m)", rung, TREE_M["ev"], TREE_M["res"])
    files = check_checkpoints("(m)", os.path.join(
        out, "m", f"ch3cn_excited_ckpt_N{TREE_M['N']}"), rung["topo"], dev)
    jobs = writer.submitted - submitted
    require(jobs == files, f"(m) {jobs} writer jobs, {files} files")
    walls["(m) Lanczos"] = rung["wall"]

    # device time of the tree algebra (ROADMAP A.10): one applyOp (apply,
    # then compress to bond 10) and one tree_als_solve at (m)'s options on
    # the card; tools/tree_device_host.py times the same on the CPU
    ttno = rung["op"]._ttno_cache[(rung["topo"], None)]
    v = TTNSVector(rung["vectors"][0].tensors, excited_production.options(
        TREE_M["params"]["maxD"], TREE_M["params"]["L"], 2),
        topo=rung["topo"]).normalize().compress()
    reset_host_reads()
    apply_ms = wall_ms(lambda: v.applyOp(ttno), 5, dev)
    per_apply = {k: n // 6 for k, n in host_reads.items()}
    reset_host_reads()
    lin = v.options["linearSystemArgs"]
    als_ms = wall_ms(lambda: tree_als_solve(
        rung["topo"], ttno.tensors, v.tensors, rung["sigma"], sign=1.0,
        maxD=lin["maxD"], eps=lin["eps"], nSweep=lin["nSweep"],
        convTol=lin["convTol"], local_tol=lin["siteTol"],
        local_maxiter=lin["linearIter"]), 3, dev)
    per_solve = {k: n // 4 for k, n in host_reads.items()}
    print(f"[tree A.10] bond {v.maxD}, N={TREE_M['N']}, on the card, "
          f"medians of 5 / 3 calls, host clock: applyOp {apply_ms:.2f} ms "
          f"({per_apply}), tree_als_solve {als_ms:.1f} ms ({per_solve}); "
          f"one applyOp's device time by kernel: "
          f"{'; '.join(device_times(lambda: v.applyOp(ttno))[:4])}",
          flush=True)
    return walls


def flagship(dev, out):
    """(r): the N = 42 rung of the excited ladder, seeded from the committed
    N = 24 states (``--seed-rung 24``), at the parameters of
    artifacts/ch3cn_production.jsonl:17, every iteration checkpointed
    through the native writer.  Returns its wall."""
    rung, peak = ladder_rung("(r)", dev, out, FLAGSHIP["N"],
                             FLAGSHIP["params"],
                             seed_rung=FLAGSHIP["seed_rung"],
                             checkpoint=True)
    rec = rung["record"]
    require(rec["converged"] and rung["status"]["isConverged"],
            "(r) not converged")
    require(rung["zpve_cm1"] == FLAGSHIP["zpve"], f"(r) zpve "
            f"{rung['zpve_cm1']}, want line 12's {FLAGSHIP['zpve']}")
    ev_cm = check_rung("(r)", rung, FLAGSHIP["ev"], FLAGSHIP["res"])
    check_checkpoints("(r)", os.path.join(
        out, f"ch3cn_excited_ckpt_N{FLAGSHIP['N']}"), rung["topo"], dev)
    for name, src in FLAGSHIP_SOURCES.items():
        print(f"[tree (r)] against {name}: "
              f"{', '.join(f'{a - b:+.4f}' for a, b in zip(ev_cm, src))} "
              f"cm-1", flush=True)
    print(f"[tree (r)] N={rec['N']} seeded from N={FLAGSHIP['seed_rung']}: "
          f"cumIter {rec['cumIter']} (the record's 2), wall "
          f"{rung['wall']:.2f} s, peak device memory {peak:.3f} GB, host "
          f"reads {dict(host_reads)}", flush=True)
    return rung["wall"]


def run_examples(dev, out):
    """(q): the ported example drivers on the card, each through its
    ``run``, each held to its own oracle.  Returns {name: wall}."""
    from eigensolvers_tpu_torch.examples import (
        ch3cn_block_lanczos, ch3cn_dmrg_zpve, ch3cn_feast,
        ch3cn_feast_production, ch3cn_production, ch3cn_targeted_lanczos,
        chebyshev_window, driver_dense, feast_window, mps_sop_lanczos,
        pyrazine_vibronic, spectrum_slicing, state_following_ho,
        ttns_tree_lanczos)

    def rel(a, b):
        return abs(a - b) / abs(b)

    def near(vals, x):
        vals = np.asarray(vals, float)
        return float(vals[np.argmin(np.abs(vals - x))])

    walls = {}

    def example(name, fn, check):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        ok, what = check(r)
        print(f"[q] {name}: {what}; wall {walls[name]:.2f} s", flush=True)
        require(ok, f"(q) {name}: {what}")

    o = lambda n: os.path.join(out, n)  # noqa: E731
    for large in (False, True):
        example(f"driver_dense{' --large' if large else ''}",
                lambda: driver_dense.run(large, device=dev, out=o("dense")),
                lambda r: (r["status"]["isConverged"] and rel(
                    r["nearest"], r["exact"]) <= EX_TOL["dense"],
                    f"{r['nearest']:.10f} against {r['exact']:.10f}"))
    example("feast_window", lambda: feast_window.run(dev, o("feast")),
            lambda r: (max(rel(near(r["ev"], e), e) for e in r["exact"])
                       <= EX_TOL["feast"],
                       f"{r['ev']} for the window levels {r['exact']}"))
    example("chebyshev_window", lambda: chebyshev_window.run(dev, o("cheb")),
            lambda r: (len(r["ev"]) == len(r["exact"]) and max(
                rel(a, b) for a, b in zip(r["ev"], r["exact"]))
                <= EX_TOL["cheb"], f"{r['ev']} for {r['exact']}"))
    example(f"spectrum_slicing n={SLICING_EX['n']}",
            lambda: spectrum_slicing.run(dev, **SLICING_EX),
            lambda r: (r["max_err"] <= EX_TOL["slicing"],
                       f"found {r['status']['found_total']} of "
                       f"{len(r['exact'])}, max |ev err| {r['max_err']:.2e}"))
    example("state_following_ho",
            lambda: state_following_ho.run(dev, o("follow")),
            lambda r: (rel(r["followed"], r["exact"]) <= EX_TOL["follow"],
                       f"{r['followed']:.10f} against {r['exact']:.10f}"))
    example("pyrazine_vibronic",
            lambda: pyrazine_vibronic.run(dev, o("pyrazine")),
            lambda r: (rel(r["level"], r["exact"]) <= EX_TOL["pyrazine"],
                       f"{r['level']:.10f} against {r['exact']:.10f} a.u."))
    example("mps_sop_lanczos", lambda: mps_sop_lanczos.run(dev, o("mps")),
            lambda r: (r["rel_err"] <= EX_TOL["mps"],
                       f"rel err {r['rel_err']:.1e}"))
    example("ttns_tree_lanczos", lambda: ttns_tree_lanczos.run(dev, o("ttns")),
            lambda r: (True, f"Krylov {r['krylov']:.10f}, ALS "
                       f"{r['als']:.10f}, oracle {r['exact']:.10f}"))
    pair8 = [e - TREE_L["zpve"] for e in TREE_L["ev"]]
    example("ch3cn_feast_production N=8",
            lambda: ch3cn_feast_production.run(
                8, nc=4, maxit=2, nSweep=2, device=dev, out=o("tfeast")),
            lambda r: (len(r["in_window_cm1"]) == 2 and all(
                abs(a - b) <= EX_TOL["tree_feast_cm"]
                for a, b in zip(r["in_window_cm1"], pair8)),
                f"in window {r['in_window_cm1']} cm-1 (the N = 8 Lanczos "
                f"pair {[round(e, 4) for e in pair8]})"))
    example("ch3cn_dmrg_zpve 12 6",
            lambda: ch3cn_dmrg_zpve.run(12, 6, device=dev),
            lambda r: (abs(r["zpve_cm1"] - CHAIN_N14_CM) <= EX_TOL["dmrg_cm"],
                       f"zpve {r['zpve_cm1']:.4f} cm-1"))
    example("ch3cn_targeted_lanczos 6 8 8",
            lambda: ch3cn_targeted_lanczos.run(6, 8, 8, device=dev,
                                               out=o("target")),
            lambda r: (abs(r["zpve_cm1"] - CHAIN_N14_CM)
                       <= EX_TOL["targeted_cm"],
                       f"zpve {r['zpve_cm1']:.4f} cm-1"))
    example("ch3cn_block_lanczos 8 8 4 2",
            lambda: ch3cn_block_lanczos.run(8, 8, 4, 2, device=dev,
                                            out=o("block")),
            lambda r: (abs(near(r["rel_cm1"], TREE_TARGET_CM)
                           - np.mean(pair8)) <= EX_TOL["block_cm"],
                       f"levels above the DMRG zpve "
                       f"{np.round(np.sort(r['rel_cm1']), 3)} cm-1, the one "
                       f"nearest the target against the N = 8 pair "
                       f"{[round(e, 4) for e in pair8]}"))
    example("ch3cn_feast 6 4 8",
            lambda: ch3cn_feast.run(6, 4, 8, device=dev, out=o("cfeast")),
            lambda r: (len(r["errors_cm1"]) > 0 and max(r["errors_cm1"])
                       <= EX_TOL["chain_feast_cm"],
                       f"found {np.round(r['found_cm1'], 3)} cm-1, errors "
                       f"against DMRG {r['errors_cm1']}"))
    example("ch3cn_production 14 --seed-rung 14",
            lambda: ch3cn_production.run([14], device=dev, out=o("ladder"),
                                         seed_rung=14),
            lambda r: (abs(r["rungs"][0]["zpve_cm1"] - CHAIN_N14_CM)
                       <= EX_TOL["ladder_cm"],
                       f"zpve {r['rungs'][0]['zpve_cm1']:.4f} cm-1 (the "
                       f"committed rung {CHAIN_N14_CM})"))
    return walls


def last_examples(dev, out):
    """(s): the maxD ladder at N = 42, the representation check, the 2-mode
    study and the FEAST-filter diagnosis on the card, each through its
    ``run`` and held to its gates.  Returns {piece: wall}."""
    from eigensolvers_tpu_torch.examples import (
        ch3cn_maxd_ladder, ch3cn_representation_2mode,
        ch3cn_representation_check)
    from eigensolvers_tpu_torch.tools import diag_feast_filter

    walls = {}

    def piece(name, fn):
        reset_host_reads()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        print(f"[s] {name}: wall {walls[name]:.2f} s, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB, host reads "
              f"{dict(host_reads)}", flush=True)
        return r

    o = lambda n: os.path.join(out, n)  # noqa: E731
    # (s1)
    lad = piece("(s1) maxD ladder N=42", lambda: ch3cn_maxd_ladder.run(
        LADDER["Ds"], N=LADDER["N"], nSweep=LADDER["nSweep"], device=dev,
        out=o("ladder")))
    require(lad["seed"] == os.path.join(examples._common.ART,
                                        f"ch3cn_state_N{LADDER['N']}.npz"),
            f"(s1) seeded from {lad['seed']}")
    require([r["maxD"] for r in lad["rungs"]] == list(LADDER["Ds"]),
            f"(s1) rungs {[r['maxD'] for r in lad['rungs']]}")
    for r in lad["rungs"]:
        d = r["zpve_cm1"] - LADDER["zpve"]
        print(f"[s1] maxD {r['maxD']}: zpve {r['zpve_cm1']:.6f} cm-1, "
              f"{d:+.6f} from the record's {LADDER['zpve']}; state_maxD "
              f"{r['record']['state_maxD']} (the record's 10); wall "
              f"{r['wall']:.2f} s", flush=True)
        require(abs(d) <= LADDER["tol"], f"(s1) maxD {r['maxD']}: zpve "
                f"{r['zpve_cm1']}, record {LADDER['zpve']}")
    print(f"[s1] MPO bonds {lad['mpo_bonds']}", flush=True)
    # (s2)
    r = piece("(s2) representation check dvr N=42",
              lambda: ch3cn_representation_check.run(device=dev,
                                                     out=o("rep42")))
    print(f"[s2] dvr N=42 maxD 10, 12 sweeps from the committed FBR state: "
          f"zpve {r['zpve_cm1']:.4f} cm-1, "
          f"{r['zpve_cm1'] - REP_COLLAPSE_CM:+.4f} from the JAX record's "
          f"{REP_COLLAPSE_CM}", flush=True)
    require(r["seeded"] and r["zpve_cm1"] < 0, f"(s2) dvr N=42: zpve "
            f"{r['zpve_cm1']}, the record's collapse not reproduced")
    for rep in ("dvr", "fbr"):
        want = REP_CHECK["zpve"][rep]
        r = piece(f"(s2) representation check {rep} N={REP_CHECK['N']}",
                  lambda: ch3cn_representation_check.run(
                      N=REP_CHECK["N"], maxD=REP_CHECK["maxD"], rep=rep,
                      nSweep=REP_CHECK["nSweep"], device=dev,
                      out=o(f"rep_{rep}")))
        rel = abs(r["zpve_cm1"] - want) / abs(want)
        print(f"[s2] {rep} N={REP_CHECK['N']} maxD {REP_CHECK['maxD']}, "
              f"{REP_CHECK['nSweep']} sweeps from the committed FBR state: "
              f"zpve {r['zpve_cm1']:.6f} cm-1, the JAX package's {want} "
              f"(rel {rel:.2e}); MPO bonds {r['mpo_bonds']}", flush=True)
        require(r["seeded"] and rel <= REP_CHECK["rtol"],
                f"(s2) {rep}: zpve {r['zpve_cm1']}, want {want}")
    # (s3)
    st = piece("(s3) 2-mode study", lambda: ch3cn_representation_2mode.run(
        mode_cuts=REP_2MODE["mode_cuts"], device=dev, out=o("rep2")))
    dense = [r for r in st["rows"] if "nModes" not in r]
    require(abs(st["oracle_cm1"] - REP_2MODE["zpve"]) <= REP_2MODE["dense_tol"]
            and len(dense) == 6 and all(
                abs(r["zpve_cm1"] - REP_2MODE["zpve"])
                <= REP_2MODE["dense_tol"] and r["n_collapsed_below"] == 0
                for r in dense),
            f"(s3) oracle {st['oracle_cm1']}, rows {dense}")
    four = [st["dmrg_cm1"][4, rep] for rep in ("fbr", "dvr")]
    require(all(abs(z - REP_2MODE["four_mode"]) <= REP_2MODE["dmrg_tol"]
                for z in four), f"(s3) 4-mode rows {four}")
    rows = [(r["representation"], r["N"], r["zpve_cm1"],
             r["lowest_state_cm1"]) for r in dense]
    print(f"[s3] oracle {st['oracle_cm1']:.6f} cm-1; dense rows (rep, N, "
          f"zpve, lowest) {rows}; DMRG rows "
          f"{[r for r in st['rows'] if 'nModes' in r]}; walls "
          f"{ {k: round(v, 2) for k, v in st['walls'].items()} }", flush=True)
    # (s4)
    dg = piece(f"(s4) FEAST filter diagnosis N={DIAG_N}",
               lambda: diag_feast_filter.run(DIAG_N, device=dev))
    for r in dg["rows"]:
        print(f"[s4] N={DIAG_N} [{r['name']}] guess RQ "
              f"{r['guess_rq_cm1']:.4f} cm-1, rel res {r['rel_res']:.6e}, "
              f"filtered RQ {r['filtered_rq_cm1']:.4f} cm-1, |x| "
              f"{r['norm_x']:.6e}, solve {r['wall']:.2f} s", flush=True)
        require(np.isfinite([r["guess_rq_cm1"], r["rel_res"],
                             r["filtered_rq_cm1"], r["norm_x"]]).all(),
                f"(s4) {r}")
    return walls


def row_library(dataT, idx, X, ncols, ref, tol):
    """The library yardstick of a row block: one ``torch.sparse_bsr_tensor``
    product of the block's rows (the stored blocks, ELL padding included)
    with the whole x, held to ``ref()`` first; (ms or None, note)."""
    A = sparse_bsr(dataT, idx, ncols)
    x = X if X.ndim == 1 else X.T.contiguous()
    try:
        y = A @ x
        torch.cuda.synchronize()
    except Exception as e:
        return None, (f"refused: {type(e).__name__}: "
                      f"{str(e).splitlines()[0][:200]}")
    err = relerr(y.T if y.ndim == 2 else y, ref())
    if not err <= tol:
        return None, f"disagrees with the plain product: {err:.2e}"
    ms = min(time_ms(lambda: A @ x), time_ms(lambda: A @ x))
    names = "; ".join(kernel_names(lambda: A @ x))
    return ms, (f"A @ x, A the rows' torch.sparse_bsr_tensor (rel err "
                f"{err:.1e}); kernels: {names}")


def row_blocks(op32, op64, op_high, dev):
    """(n0): each kernel launched on ROW_RANGES ranges of block rows with
    the whole x (``ncb`` = nrb) against the rows of its square launch
    (bitwise) and its plain rectangular version; range 0 timed beside its
    bound (that range's blocks + idx, the whole x, the local y), B1's also
    by its device time (the profiler's); the square B1 (f32, f64) and B3
    (m = 2, 64) re-timed, B1 with its device time.  Launches made here are
    checks, not main-path runs: the caller zeroes the counters after."""
    nrb, nbpr, B, _ = op32.dataT.shape
    npad, per = nrb * B, nrb // ROW_RANGES
    rng = np.random.RandomState(8)
    X64 = torch.as_tensor(rng.standard_normal((64, npad)), device=dev)
    X32 = X64.float()
    idx = op32.idx
    hi, lo = op_high.dataT_hi, op_high.dataT_lo
    stol = split_tol(nbpr, B)

    def x_of(dtype, m):
        X = X64 if dtype == "f64" else X32
        return X[:m].contiguous() if m > 1 else X[0].contiguous()

    # (name, m, kind, blocks, x, kernel, plain reference, tolerance)
    cases = []
    for name, m, kind in (("bsr_spmv f32", 1, "f32"),
                          ("bsr_spmv f64", 1, "f64"),
                          ("bsr_spmv_split", 1, "split"),
                          ("bsr_spmm f32", 2, "f32"),
                          ("bsr_spmm f32", 16, "f32"),
                          ("bsr_spmm f32", 64, "f32"),
                          ("bsr_spmm f64", 48, "f64")):
        X = x_of(kind, m)
        if name == "bsr_spmv_split":
            blocks = (hi, lo)
            kern = lambda bl, i, x, **kw: bsr.bsr_matvec_split(  # noqa: E731
                *bl, i, x, **kw)
            plain = lambda bl, i, x: bsr.bsr_matvec_split_plain(  # noqa: E731
                *bl, i, x, acc=torch.float64)
            tol = stol
        elif m == 1:
            blocks = (op64.dataT if kind == "f64" else op32.dataT,)
            kern = lambda bl, i, x, **kw: bsr.bsr_matvec(  # noqa: E731
                *bl, i, x, **kw)
            plain = lambda bl, i, x: bsr.bsr_matvec_plain(  # noqa: E731
                *bl, i, x)
            tol = KERNEL_TOL[kind]
        else:
            blocks = (op64.dataT if kind == "f64" else op32.dataT,)
            kern = lambda bl, i, x, **kw: bsr.bsr_matmat(  # noqa: E731
                *bl, i, x, **kw)
            plain = lambda bl, i, x: bsr.bsr_matmat_plain(  # noqa: E731
                *bl, i, x)
            tol = KERNEL_TOL[kind]
        cases.append((name, m, kind, blocks, X, kern, plain, tol))

    rows_out = []
    for name, m, kind, blocks, X, kern, plain, tol in cases:
        Y = kern(blocks, idx, X)
        torch.cuda.synchronize()
        errs = []
        for k in range(ROW_RANGES):
            r0, r1 = k * per, (k + 1) * per
            bl = tuple(b[r0:r1] for b in blocks)
            Yr = kern(bl, idx[r0:r1], X, ncb=nrb)
            torch.cuda.synchronize()
            same = torch.equal(Yr, Y[..., r0 * B:r1 * B])
            require(same, f"(n0) {name} m={m} rows [{r0}, {r1}): not equal "
                    f"to the square launch's rows")
            err = relerr(Yr, plain(bl, idx[r0:r1], X))
            require(err <= tol, f"(n0) {name} m={m} rows [{r0}, {r1}): rel "
                    f"err {err:.3e} > {tol:.0e}")
            errs.append(err)
        bl = tuple(b[:per] for b in blocks)
        ms_k = min(time_ms(lambda: kern(bl, idx[:per], X, ncb=nrb)),
                   time_ms(lambda: kern(bl, idx[:per], X, ncb=nrb)))
        b1 = name.startswith("bsr_spmv ")
        dev_ms = device_ms(lambda: kern(bl, idx[:per], X, ncb=nrb)) \
            if b1 else None
        host = host_us(lambda: kern(bl, idx[:per], X, ncb=nrb)) if b1 else None
        ms_p = time_ms(lambda: plain(bl, idx[:per], X), reps=5)
        size = 8 if kind == "f64" else 4
        elems = bl[0].numel()
        b_ms, b_by = bound(elems * size, per * nbpr * 4, m, npad, size,
                           (6 if kind == "split" else 2) * elems * m,
                           PEAK_FLOPS["bf16" if kind == "split" else kind],
                           npad_out=per * B)
        lib_ms, lib = None, NO_LIBRARY
        if kind != "split":
            lib_ms, lib = row_library(bl[0], idx[:per], X, npad,
                                      lambda: plain(bl, idx[:per], X), tol)
        rows_out.append(dict(name=name, m=m, ms=ms_k, plain_ms=ms_p,
                             bound_ms=b_ms, bound_by=b_by, err=max(errs),
                             library_ms=lib_ms, library=lib,
                             device_ms=dev_ms, host_us=host))
        print(f"[n0] {name} m={m}: {ROW_RANGES} row blocks of {per} block "
              f"rows, each bitwise equal to the square launch's rows; rel "
              f"err against the plain rectangular version "
              f"{max(errs):.3e} (tol {tol:.0e}); rows [0, {per}): kernel "
              f"{ms_k:.4f} ms"
              + ((f" (device {dev_ms:.4f} ms, launch gap "
                  f"{ms_k - dev_ms:.4f} ms" if dev_ms is not None else
                  f" (device {NOT_MEASURED}") + f"; host time of one call "
                 f"{host:.1f} us)" if b1 else "")
              + f", bound {b_ms:.4f} ms ({b_by}; "
              f"{b_ms / ms_k:.0%}), plain {ms_p:.4f} ms, library "
              + (f"{lib_ms:.4f} ms [{lib}]" if lib_ms is not None else lib),
              flush=True)
    for (name, m), rec in RECORDED_MS.items():
        kind = name.split()[-1]
        X = x_of(kind, m)
        dataT = op64.dataT if kind == "f64" else op32.dataT

        def square():
            return (bsr.bsr_matvec if m == 1 else bsr.bsr_matmat)(dataT, idx,
                                                                  X)
        ms = min(time_ms(square) for _ in range(2))
        dev = f" (device {ms_or_none(device_ms(square))})" if m == 1 else ""
        print(f"[n0] square {name} m={m} re-timed: {ms:.4f} ms{dev} "
              f"(PERF.md section 6 records {rec:.4f} ms)", flush=True)
    return rows_out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")

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
    with ThreadPoolExecutor(len(kernels.LIBRARIES) + 1) as pool:
        builds = [pool.submit(f) for f in kernels.LIBRARIES]
        builds.append(pool.submit(fastwriter.build))
        for b in builds:
            b.result()
    print(f"[build] {', '.join(sorted(p.name for p in kernels.CSRC.glob('*.cu')))}"
          f" with {kernels.nvcc_path()}, fastio.cpp with g++: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # -- 3. kernels vs plain ------------------------------------------------
    t0 = time.perf_counter()
    H_out, h_in = slice_factors()
    e_out = np.linalg.eigvalsh(H_out)
    e_in = np.linalg.eigvalsh(h_in)
    op32 = product.kron_sum_bsr(H_out, h_in, BANDWIDTH, torch.float32, dev,
                                precision="highest")
    op64 = product.kron_sum_bsr(H_out, h_in, BANDWIDTH, torch.float64, dev)
    op_high = bsr.BSROperator.from_transposed(op32.dataT, op32.idx, op32.n,
                                              precision="high")
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

    # Bounds: the stored blocks (hi + lo for the split form: the f32
    # bytes), idx, each x lane read once and each y lane written once;
    # 2 flops per stored element and lane (6 for the three bf16 products).
    npad = op32.n_padded
    elems = op32.dataT.numel()

    def bound_of(kind, m):
        size = 8 if kind == "f64" else 4
        return bound(elems * size, idx.numel() * 4, m, npad, size,
                     (6 if kind == "split" else 2) * elems * m,
                     PEAK_FLOPS["bf16" if kind == "split" else kind])

    # The library yardstick: the stored blocks (ELL padding included, the
    # same bytes the kernels read) as a torch.sparse_bsr_tensor, built once.
    A32, A64 = sparse_bsr(op32.dataT, idx, npad), sparse_bsr(op64.dataT, idx,
                                                            npad)

    def library(A, x, ref, tol):
        """Time ``A @ x`` (x (npad,) or (npad, m)) after holding it to
        ``ref()``; returns (ms or None, what was called or why not)."""
        try:
            y = A @ x
            torch.cuda.synchronize()
        except Exception as e:
            return None, (f"refused: {type(e).__name__}: "
                          f"{str(e).splitlines()[0][:200]}")
        err = relerr(y.T if y.ndim == 2 else y, ref())
        if not err <= tol:
            return None, f"disagrees with the plain product: {err:.2e}"
        ms = min(time_ms(lambda: A @ x), time_ms(lambda: A @ x))
        return ms, (f"A @ x, A a torch.sparse_bsr_tensor (rel err {err:.1e});"
                    f" kernels: {'; '.join(kernel_names(lambda: A @ x))}")

    results = {}
    for name, kern, plain, ref, tol, gb, kind, lib in (
            ("bsr_spmv f32", lambda: bsr.bsr_matvec(op32.dataT, idx, x32),
             lambda: bsr.bsr_matvec_plain(op32.dataT, idx, x32), None,
             KERNEL_TOL["f32"], gb32, "f32",
             lambda: library(A32, x32, lambda: ref32, KERNEL_TOL["f32"])),
            ("bsr_spmv f64", lambda: bsr.bsr_matvec(op64.dataT, idx, x64),
             lambda: bsr.bsr_matvec_plain(op64.dataT, idx, x64), None,
             KERNEL_TOL["f64"], 2 * gb32, "f64",
             lambda: library(A64, x64, lambda: bsr.bsr_matvec_plain(
                 op64.dataT, idx, x64), KERNEL_TOL["f64"])),
            ("bsr_spmv_split", lambda: bsr.bsr_matvec_split(hi, lo, idx, x32),
             lambda: bsr.bsr_matvec_split_plain(hi, lo, idx, x32),
             exactX[0], split_tol(nbpr, B), gb32, "split", None)):
        results[name] = compare(f"{name} at {shape}", kern, plain,
                                ref, tol, gb, *bound_of(kind, 1), lib,
                                device=name.startswith("bsr_spmv "))
    split_checks("bsr_spmv_split", bsr.bsr_matvec_split(hi, lo, idx, x32),
                 exactX[0], bsr.bsr_matvec(op32.dataT, idx, x32), ref32,
                 "split_f64")
    for m in LANES:
        Xm32, Xm64 = X32[:m].contiguous(), X64[:m].contiguous()
        Xt32, Xt64 = Xm32.T.contiguous(), Xm64.T.contiguous()
        for name, kern, plain, ref, tol, gb, kind, lib in (
                ("bsr_spmm f32",
                 lambda: bsr.bsr_matmat(op32.dataT, idx, Xm32),
                 lambda: bsr.bsr_matmat_plain(op32.dataT, idx, Xm32), None,
                 KERNEL_TOL["f32"], gb32, "f32",
                 lambda: library(A32, Xt32, lambda: refX[:m],
                                 KERNEL_TOL["f32"])),
                ("bsr_spmm f64",
                 lambda: bsr.bsr_matmat(op64.dataT, idx, Xm64),
                 lambda: bsr.bsr_matmat_plain(op64.dataT, idx, Xm64), None,
                 KERNEL_TOL["f64"], 2 * gb32, "f64",
                 lambda: library(A64, Xt64, lambda: bsr.bsr_matmat_plain(
                     op64.dataT, idx, Xm64), KERNEL_TOL["f64"])),
                ("bsr_spmm_split",
                 lambda: bsr.bsr_matmat_split(hi, lo, idx, Xm32),
                 lambda: bsr.bsr_matmat_split_plain(hi, lo, idx, Xm32),
                 exactX[:m], split_tol(nbpr, B), gb32, "split", None)):
            results[(name, m)] = compare(f"{name} m={m} at {shape} "
                                         f"({units(name, m)})", kern, plain,
                                         ref, tol, gb, *bound_of(kind, m),
                                         lib)
        split_checks(f"bsr_spmm_split m={m}",
                     bsr.bsr_matmat_split(hi, lo, idx, Xm32), exactX[:m],
                     bsr.bsr_matmat(op32.dataT, idx, Xm32), refX[:m],
                     "split_lanes")
    del ref32, refX, exactX, X64, X32, x64, x32, A32, A64

    # ragged small shapes, up to the largest block the kernels take
    for nr, nb, Bs in ((5, 3, 32), (5, 3, 64), (5, 3, 100), (2, 2, 1024)):
        r = np.random.RandomState(Bs)
        d64 = torch.as_tensor(r.standard_normal((nr, nb, Bs, Bs)),
                              device=dev)
        i5 = torch.as_tensor(r.randint(0, nr, (nr, nb)), dtype=torch.int32,
                             device=dev)
        V64 = torch.as_tensor(r.standard_normal((129, nr * Bs)), device=dev)
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
        # across the tiles and the chunks of 64 (B3 and split)
        for m in (1, 3, 9, 16, 17, 31, 33, 47, 49, 65, 129):
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

    # every row at the slice shape, for PERF.md's kernel table
    for key, r in results.items():
        name, m = key if isinstance(key, tuple) else (key, 1)
        print(f"[row] {name} m={m} ({units(name, m)}): kernel "
              f"{r['ms']:.4f} ms"
              + (f" (device {ms_or_none(r['device_ms'])})"
                 if name.startswith("bsr_spmv ") else "") + ", bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}; "
              f"{r['bound_ms'] / r['ms']:.0%} of it), plain "
              f"{r['plain_ms']:.4f} ms, library "
              + (f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None
                 else "none") + f" [{r['library']}]", flush=True)

    # -- 4. the slice -------------------------------------------------------
    levels = product.kron_sum_levels(e_out, e_in, TARGET_LEVEL + 12)
    sigma = float(levels[TARGET_LEVEL]
                  + 0.2 * (levels[TARGET_LEVEL + 1] - levels[TARGET_LEVEL]))

    def nearest(k):
        """The k exact levels nearest sigma, ascending."""
        return np.sort(levels[np.argsort(np.abs(levels - sigma))[:k]])

    h_norm = max(abs(e_out[-1] + e_in[-1]), abs(e_out[0] + e_in[0]))
    xg = np.linspace(X_RANGE[0], X_RANGE[1], B_IN)

    def guess_block(nblock, npackets):
        """Low-energy random guesses: random amplitudes (seeds 0, 1, ...)
        on the 32 lowest outer HO functions times random smooth (polynomial
        x Gaussian) inner packets, both parities in both modes,
        orthonormalized."""
        packets = np.stack([xg ** p * np.exp(-xg ** 2 / 2)
                            for p in range(npackets)])
        guesses = np.zeros((nblock, M_OUT, B_IN))
        for s in range(nblock):
            guesses[s, :32] = np.random.RandomState(s).standard_normal(
                (32, npackets)) @ packets
        return np.linalg.qr(guesses.reshape(nblock, -1).T)[0].T

    block = guess_block(NBLOCK, 4)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = torch.zeros((), device=dev)
    for _ in range(200):
        s = s + 1
        bool(s > 0)
    host_read_us = (time.perf_counter() - t0) / 200 * 1e6

    def vectors(rows, report, linear=LINEAR):
        opts = {"linearSystemArgs": dict(linear, report=report)}
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

    def window_states(tag, ev, Y, want, dtype, prec="highest"):
        """Each exact level of a window against its nearest Ritz pair (all
        distinct): relative error and f64 residual ||Hv - lv|| / ||H||,
        held to the slice's gates at ``prec``'s eigenvalue tolerance
        (below "highest", whether "highest"'s holds too is printed).
        Returns the picked Ritz values."""
        ev = np.asarray(ev)
        require(len(ev) == len(Y) and np.all(np.isfinite(ev)),
                f"{tag}: bad eigenvalues {ev}")
        picks = [int(np.argmin(np.abs(ev - t))) for t in want]
        require(len(set(picks)) == len(want), f"{tag}: levels {want} share "
                f"Ritz values {ev}")
        rels, ress = [], []
        for k, exact in zip(picks, want):
            v = Y[k].array
            require(tuple(v.shape) == (op32.n,) and v.dtype == dtype
                    and bool(torch.isfinite(v).all()),
                    f"{tag}: bad Ritz vector {tuple(v.shape)} {v.dtype}")
            v = v.double()
            r = bsr.bsr_matvec_plain(op64.dataT, op64.idx, v) - ev[k] * v
            rels.append(abs(ev[k] - exact) / abs(exact))
            ress.append(float(torch.linalg.vector_norm(r)
                              / torch.linalg.vector_norm(v)) / h_norm)
        also = ("" if prec == "highest" else
                f"; \"highest\"'s {EV_RTOL['highest']:.0e} "
                + ("holds" if max(rels) <= EV_RTOL["highest"]
                   else "does not hold"))
        print(f"[slice {tag}] window [{e_min:.6f}, {e_max:.6f}] holds levels "
              f"{lo}..{hi}; Ritz {', '.join(f'{ev[k]:.8f}' for k in picks)} "
              f"exact {', '.join(f'{e:.8f}' for e in want)}; rel err "
              f"{', '.join(f'{e:.2e}' for e in rels)} (tol "
              f"{EV_RTOL[prec]:.0e}{also}); ||Hv-lv||/||H|| "
              f"{', '.join(f'{e:.2e}' for e in ress)} (tol {RES_TOL:.0e})",
              flush=True)
        require(max(rels) <= EV_RTOL[prec], f"{tag}: eigenvalue rel err "
                f"{max(rels):.2e}")
        require(max(ress) <= RES_TOL, f"{tag}: residual {max(ress):.2e}")
        return ev[picks]

    def check_counts(tag, counts, expected):
        """Every BSR kernel's launches in the run equal the applies the
        run reports for it; kernels not named launch 0 times (the dense and
        sum-of-products runs name none)."""
        want = {k: expected.get(k, 0) for k in counts}
        require(counts == want, f"{tag}: launches {counts}, the run "
                f"reports {want}")
        require(any(want.values()) or tag in (
            "(d) dense", "(g) dense FEAST", "(h) CH3CN Lanczos",
            "(i) dense Chebyshev"), f"{tag}: no kernel launched")

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
    b3_shapes = collections.Counter()   # (dtype, lanes) of B3 in (f), (k)
    walls = {}
    refs = {}           # the unsharded runs that (n) repeats
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
        refs[tag] = (np.asarray(ev), status, report)
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
        refs[tag] = (np.asarray(ev), status, report)
        check_states(tag, prec, ev, Y, nearest(NBLOCK))
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
    check_states(tag, "highest", ev, Y, nearest(NBLOCK))
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

    # (e): the fused driver with a block of 16, the 16 levels nearest sigma
    # (the inner mode reaches its 6th level among them: six packets); every
    # MINRES pass is one 16-lane apply
    report = {}
    tag = f"(e) fast highest, nBlock {NBLOCK_WIDE}"
    (ev, Y, status), wall, counts, unconv = run(
        fastLanczosDiagonalization, op32,
        vectors(guess_block(NBLOCK_WIDE, 6), report), sigma, LANCZOS["L"],
        LANCZOS["maxit"], LANCZOS["eConv"])
    check_states(tag, "highest", ev, Y, nearest(NBLOCK_WIDE))
    report_line(tag, status, report, wall, unconv)
    check_counts(tag, counts, {"bsr_spmm": report["matmats"]})
    walls[tag] = wall
    for k, v in counts.items():
        totals[k] += v

    # (f): FEAST on the window of levels 18..23 around sigma: f32 solves at
    # "highest", the split-complex default and the fused loop.  Every MINRES
    # pass is one B3 apply of all 2 nk m0 real lanes; each outer iteration
    # adds one f64 apply of the m0 carried vectors (the subspace H).
    lo, hi = FEAST_LEVELS
    e_min = 0.5 * float(levels[lo - 1] + levels[lo])
    e_max = 0.5 * float(levels[hi] + levels[hi + 1])
    want = levels[lo:hi + 1]
    m0, nk = FEAST["m0"], FEAST["nc"] // 2
    report = {}
    tag = "(f) FEAST highest"
    with recording_calls() as calls:
        (ev, Y, status), wall, counts, unconv = run(
            feastDiagonalization, op32,
            vectors(guess_block(m0, FEAST["npackets"]), report,
                    FEAST_LINEAR),
            FEAST["nc"], "legendre", e_min, e_max, FEAST["eConv"],
            FEAST["maxit"], writeOut=False)
    outer = status["outerIter"] + 1
    passes = report["matmats"]
    b3_ms = results[("bsr_spmm f32", F_LANES)]["ms"]
    b3_s, _ = b3_seconds(calls, results)
    b3_shapes.update((dt, m) for k, m, dt in calls if k == "bsr_spmm")
    lanes = collections.Counter(m for k, m, _ in calls if k == "bsr_spmm")
    print(f"[slice {tag}] converged {status['isConverged']} after {outer} "
          f"outer iterations (residual {status.get('residual', 0):.2e}); "
          f"{report['solves']} lane solves, {report['iterations']} MINRES "
          f"iterations ({unconv} warnings of unconverged lanes); {passes} "
          f"passes of {F_LANES} lanes; B3 launches {counts['bsr_spmm']} "
          f"by lanes {dict(sorted(lanes.items()))}; "
          f"wall {wall:.2f} s, {wall / passes * 1e3:.4f} ms/pass; B3 "
          f"{b3_ms:.4f} ms at {F_LANES} lanes ({units('bsr_spmm', F_LANES)}"
          f", phase 3), B3 {b3_s:.2f} s of the wall at phase 3's times "
          f"(share {b3_s / wall:.3f}); phases: "
          + ", ".join(f"{p} {t['seconds']:.2f} s ({t['calls']})"
                      for p, t in status["timers"].items()), flush=True)
    require(len(ev) == m0 and len(Y) == m0, f"{tag}: the subspace shrank "
            f"to {len(ev)}")
    f_levels = window_states(tag, ev, Y, want, torch.float64)
    f_run = dict(passes=passes, iterations=report["iterations"], wall=wall)
    check_counts(tag, counts, {"bsr_spmm": passes + outer})
    require(len(calls) == counts["bsr_spmm"] and lanes[F_LANES] == passes
            and lanes[m0] == outer, f"{tag}: B3 lane counts {lanes}, "
            f"expected {passes} x {F_LANES} and {outer} x {m0}")
    walls[tag] = wall
    for k, v in counts.items():
        totals[k] += v
    # one pass of (f) as the card sees it: 100 passes of the same lane
    # stack (the window's nodes, one per m0 guesses), rtol 0
    zs = _contour(e_min, e_max, FEAST["nc"], "legendre", 1.0)[3]
    Bf = torch.as_tensor(guess_block(m0, FEAST["npackets"]),
                         dtype=torch.float32, device=dev).repeat(nk, 1)
    prof = profile_passes(lambda: gmres_splitc_batch(
        op32, Bf, np.repeat(zs, m0), rtol=0.0, maxiter=100, escalate=0,
        precond="jacobi"))
    print(f"[slice {tag}] one pass of {F_LANES} lanes under torch.profiler: "
          + json.dumps(prof), flush=True)

    # (t): FEAST at "high" on (f)'s window, with (f)'s nc, m0, solve options
    # and guesses, on op_high (op32's blocks split into bf16 hi/lo).  Every
    # MINRES pass is one bsr_spmm_split launch of all 2 nk m0 real lanes;
    # each outer iteration adds one f64 B3 apply of the m0 carried vectors
    # (the subspace H, on the f32 blocks).  Gated at "high"'s eigenvalue
    # tolerance and (f)'s f64 residual.
    report = {}
    tag = "(t) FEAST high"
    with recording_calls() as calls:
        (ev, Y, status), wall, counts, unconv = run(
            feastDiagonalization, op_high,
            vectors(guess_block(m0, FEAST["npackets"]), report,
                    FEAST_LINEAR),
            FEAST["nc"], "legendre", e_min, e_max, FEAST["eConv"],
            FEAST["maxit"], writeOut=False)
    outer = status["outerIter"] + 1
    passes = report["matmats"]
    split_ms = results[("bsr_spmm_split", F_LANES)]["ms"]
    split_s = passes * split_ms / 1e3
    print(f"[slice {tag}] converged {status['isConverged']} after {outer} "
          f"outer iterations (residual {status.get('residual', 0):.2e}); "
          f"{report['solves']} lane solves, {report['iterations']} MINRES "
          f"iterations ({unconv} warnings of unconverged lanes); {passes} "
          f"passes of {F_LANES} lanes; launches {counts}; wall {wall:.2f} s, "
          f"{wall / passes * 1e3:.4f} ms/pass; bsr_spmm_split "
          f"{split_ms:.4f} ms at {F_LANES} lanes (phase 3), {split_s:.2f} s "
          f"of the wall at that time (share {split_s / wall:.3f}); phases: "
          + ", ".join(f"{p} {t['seconds']:.2f} s ({t['calls']})"
                      for p, t in status["timers"].items()), flush=True)
    require(len(ev) == m0 and len(Y) == m0, f"{tag}: the subspace shrank "
            f"to {len(ev)}")
    t_levels = window_states(tag, ev, Y, want, torch.float64, "high")
    check_counts(tag, counts, {"bsr_spmm_split": passes, "bsr_spmm": outer})
    want_calls = collections.Counter({
        ("bsr_spmm_split", F_LANES, torch.float32): passes,
        ("bsr_spmm", m0, torch.float64): outer})
    require(collections.Counter(calls) == want_calls, f"{tag}: calls "
            f"{collections.Counter(calls)}, expected {want_calls}")
    split_launches = counts["bsr_spmm_split"]
    print(f"[slice {tag}] against (f) \"highest\": passes {passes} / "
          f"{f_run['passes']}, MINRES iterations {report['iterations']} / "
          f"{f_run['iterations']}, wall {wall:.2f} / {f_run['wall']:.2f} s, "
          f"ms/pass {wall / passes * 1e3:.4f} / "
          f"{f_run['wall'] / f_run['passes'] * 1e3:.4f}; levels "
          f"{', '.join(f'{e:.8f}' for e in t_levels)} / "
          f"{', '.join(f'{e:.8f}' for e in f_levels)}, largest gap "
          f"{np.max(np.abs(t_levels - f_levels) / np.abs(want)):.2e} "
          f"relative", flush=True)
    walls[tag] = wall
    for k, v in counts.items():
        totals[k] += v
    prof = profile_passes(lambda: gmres_splitc_batch(
        op_high, Bf, np.repeat(zs, m0), rtol=0.0, maxiter=100, escalate=0,
        precond="jacobi"))
    print(f"[slice {tag}] one pass of {F_LANES} lanes under torch.profiler: "
          + json.dumps(prof), flush=True)

    # (j): the Chebyshev window on the slice, (f)'s window.  The entry
    # point's own bounds estimate (30 B1 launches) is taken and printed,
    # with the filter's per-round rate on the exact spectrum for it and for
    # the spectrum's own bounds padded by 1 (bench_chebyshev's padding),
    # which the run is given: the estimate's lower margin puts the window
    # in the interior of [a, b], where degree 8,000 cannot resolve it.
    # Every filter step is one B3 launch of m0 lanes at the state's dtype;
    # each round's Rayleigh-Ritz apply, the enrichment's two and the
    # certificate one B3 launch of m0 f64 lanes each.
    cs = CHEB_SLICE
    sdt = cs["dtype"]
    op_j = op32 if sdt == torch.float32 else op64
    lam = np.sort((e_out[:, None] + e_in[None, :]).ravel())
    spec = (float(lam[0]) - 1.0, float(lam[-1]) + 1.0)
    tag = "(j) Chebyshev highest"
    est, wall_b, counts, _ = run(cheb.estimate_spectral_bounds, op_j,
                                 op_j.n, dtype=sdt)
    require(counts == dict(dict.fromkeys(counts, 0), bsr_spmv=30),
            f"{tag}: bounds estimate launches {counts}")
    for k, v in counts.items():
        totals[k] += v
    degree_j = cheb.adaptive_degree(*spec, e_min, e_max)
    print(f"[slice {tag}] spectrum [{lam[0]:.4f}, {lam[-1]:.4f}]; the entry "
          f"point's estimate [{est[0]:.4f}, {est[1]:.4f}] in {wall_b:.2f} s "
          f"(30 B1 launches); degree {degree_j} (3.5 x span / width = "
          f"{3.5 * (spec[1] - spec[0]) / (e_max - e_min):.0f} before the "
          f"clip); per-round filter rate |p(l_m0+1)| / min_window |p| at m0 "
          f"= 8, 12, 16 on the exact spectrum: estimated bounds "
          f"{filter_rates(lam, *est, degree_j, e_min, e_max)}, the "
          f"spectrum's +-1 {filter_rates(lam, *spec, degree_j, e_min, e_max)}",
          flush=True)
    attempts = []                   # (degree, rounds) of each fused attempt
    fused = cheb._fused_window

    def fused_recorded(op, W, cf, *args):
        out = fused(op, W, cf, *args)
        attempts.append((len(cf) - 1, out[3]))
        return out

    cheb._fused_window = fused_recorded
    try:
        with recording_calls() as calls:
            (ev, Y, status), wall, counts, _ = run(
                chebyshevFilteredDiagonalization, op_j,
                [TorchVector(torch.as_tensor(g, dtype=sdt, device=dev))
                 for g in guess_block(cs["m0"], cs["npackets"])],
                None, e_min, e_max, cs["eConv"], cs["maxit"],
                specBounds=spec, writeOut=False)
    finally:
        cheb._fused_window = fused
    vres = np.asarray(status["vecResiduals"])
    print(f"[slice {tag}] {str(sdt)[6:]} state, m0 {cs['m0']}: attempts "
          f"(degree, rounds) {attempts}; converged {status['isConverged']}, "
          f"residual {status['residual']:.2e}, outerIter "
          f"{status['outerIter']}; vector residuals "
          f"{', '.join(f'{r:.2e}' for r in vres)}; wall {wall:.2f} s, "
          f"{wall / max(1, count_calls(calls, 'bsr_spmm')) * 1e3:.4f} "
          f"ms/apply; launches {counts}", flush=True)
    window_states(tag, ev, Y, want, torch.float64)
    filt = sum(d * r for d, r in attempts)
    rr = sum(r + 3 for _, r in attempts)
    want_calls = collections.Counter({("bsr_spmm", cs["m0"], sdt): filt})
    want_calls[("bsr_spmm", cs["m0"], torch.float64)] += rr
    require(collections.Counter(calls) == want_calls, f"{tag}: calls "
            f"{collections.Counter(calls)}, expected {want_calls}")
    check_counts(tag, counts, {"bsr_spmm": filt + rr})
    walls[tag] = wall_b + wall
    for k, v in counts.items():
        totals[k] += v

    # (k): spectrum slicing over (f)'s window on the f64 operator, on (j)'s
    # bounds (the spectrum's, padded by 1).  The moments: one B3 launch of
    # nProbes lanes per degree; the sweep repeats them, then each window's
    # fused FEAST (its passes, one f64 subspace apply per outer iteration)
    # and the polish (batched MINRES passes, one B1 per pair and round for
    # the Rayleigh quotient and per pair for the residual)
    sl = SLICING
    tag = "(k) spectrum slicing"
    with recording_calls() as calls:
        (mu, (a_, b_)), wall_mu, counts, _ = run(
            chebyshev_moments, op64, op64.n, degree=sl["degree"],
            nProbes=sl["nProbes"], bounds=spec, seed=sl["seed"])
    require(counts == dict(dict.fromkeys(counts, 0), bsr_spmm=sl["degree"])
            and count_calls(calls, "bsr_spmm", sl["nProbes"], torch.float64)
            == sl["degree"], f"{tag}: moment launches {counts}")
    for k, v in counts.items():
        totals[k] += v
    mid = 0.5 * (e_min + e_max)
    kpm = []
    for w_lo, w_hi in ((e_min, e_max), (e_min, mid), (mid, e_max)):
        count = window_count_from_moments(mu, a_, b_, w_lo, w_hi, op64.n)
        exact = int(np.sum((levels >= w_lo) & (levels <= w_hi)))
        kpm.append((w_lo, w_hi, count, exact))
        require(abs(count - exact) <= max(sl["count_atol"],
                                           sl["count_rtol"] * exact),
                f"{tag}: KPM count {count:.2f} in [{w_lo}, {w_hi}], exact "
                f"{exact}")
    print(f"[slice {tag}] KPM moments of degree {sl['degree']} from "
          f"{sl['nProbes']} probes on [{a_:.4f}, {b_:.4f}]: counts "
          + ", ".join(f"[{w0:.4f}, {w1:.4f}] {e:.2f} (exact {x})"
                      for w0, w1, e, x in kpm)
          + f"; wall {wall_mu:.2f} s, launches {counts}", flush=True)
    report = {}
    with recording_calls() as calls:
        (ev, Y, st), wall, counts, unconv = run(
            spectrumSlicingDiagonalization, op64, e_min, e_max,
            nWindows=sl["nWindows"], nc=FEAST["nc"], eConv=sl["eConv"],
            maxit=sl["maxit"], polish_rounds=sl["polish_rounds"],
            degree=sl["degree"], nProbes=sl["nProbes"], bounds=spec,
            seed=sl["seed"],
            options={"linearSystemArgs": dict(
                FEAST_LINEAR, linearIter=sl["linearIter"], report=report)})
    wins = st["windows"]
    polished = [] if st["residuals"] is None else st["residuals"]
    k3 = "bsr_spmm"
    outer = sum(w["feast_status"]["outerIter"] + 1 for w in wins)
    merged = st["found_total"] + st["dropped_spurious"]
    print(f"[slice {tag}] windows "
          + ", ".join(f"[{w['window'][0]:.6f}, {w['window'][1]:.6f}) est "
                      f"{w['estimated']:.2f} m0 {w['m0']} found {w['found']}"
                      f" converged {w['isConverged']} after "
                      f"{w['feast_status']['outerIter'] + 1} iterations"
                      for w in wins)
          + f"; found {st['found_total']}, dropped_spurious "
          f"{st['dropped_spurious']}, residual_certified "
          f"{st['residual_certified']}, polished residuals "
          f"{', '.join(f'{r:.2e}' for r in polished)}; "
          f"{report['solves']} solves, {report['iterations']} MINRES "
          f"iterations ({unconv} warnings), {report['matmats']} lane-stack "
          f"applies; B3 calls by lanes "
          f"{dict(collections.Counter(m for k, m, _ in calls if k == k3))}"
          f"; wall {wall:.2f} s", flush=True)
    b3_s, missing = b3_seconds(calls, results)
    b3_shapes.update((dt, m) for k, m, dt in calls if k == k3)
    print(f"[slice {tag}] B3 {b3_s:.2f} s of the wall {wall:.2f} s at "
          f"phase 3's times (share {b3_s / wall:.3f}; "
          f"{results[('bsr_spmm f64', 48)]['ms']:.4f} ms at 48 f64 lanes, "
          f"{units('bsr_spmm', 48)})"
          + (f"; not timed in phase 3: {sorted(missing)}" if missing else ""),
          flush=True)
    require(st["found_total"] == len(want), f"{tag}: found "
            f"{st['found_total']} pairs for {len(want)} levels: {ev}")
    require(isinstance(st["dropped_spurious"], int), f"{tag}: no "
            f"dropped_spurious")
    window_states(tag, ev, Y, want, torch.float64)
    require(st["residual_certified"] or all(w["isConverged"] for w in wins),
            f"{tag}: neither residual-certified nor every window converged")
    expected = {"bsr_spmv": merged * (sl["polish_rounds"] + 1),
                "bsr_spmm": sl["degree"] + report["matmats"] + outer}
    require(count_calls(calls, "bsr_spmm", dtype=torch.float64)
            == expected["bsr_spmm"] and count_calls(
                calls, "bsr_spmv", dtype=torch.float64)
            == expected["bsr_spmv"], f"{tag}: calls "
            f"{collections.Counter(calls)}, expected {expected} in f64")
    check_counts(tag, counts, expected)
    walls[tag] = wall_mu + wall
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

    # (g): bench.py's FEAST window task (bench_feast), f32 on the card
    fb = FEAST_BENCH
    Hg, evg = known_spectrum_matrix(
        fb["n"], eigenvalues=np.linspace(1, float(fb["n"]), fb["n"]),
        seed=10)
    truth = select_within_range(evg, fb["eMin"], fb["eMax"])[0]
    Yg = np.linalg.qr(np.random.RandomState(3).rand(fb["n"], fb["m0"]))[0]
    report = {}
    gopts = {"linearSystemArgs": dict(FEAST_BENCH_LINEAR, report=report)}
    tag = "(g) dense FEAST"
    (ev, Y, status), wall, counts, unconv = run(
        feastDiagonalization,
        DenseOperator(np.asarray(Hg).astype(np.float32), device=dev),
        [TorchVector(torch.as_tensor(Yg[:, i], dtype=torch.float32,
                                     device=dev), gopts)
         for i in range(fb["m0"])],
        fb["nc"], "legendre", fb["eMin"], fb["eMax"], fb["eConv"],
        fb["maxit"], writeOut=False)
    got = np.sort(select_within_range(np.asarray(ev), fb["eMin"],
                                      fb["eMax"])[0])
    errs = [float(np.min(np.abs(got - t))) if len(got) else 9e9
            for t in truth]
    print(f"[slice {tag}] n={fb['n']} window [{fb['eMin']}, {fb['eMax']}]: "
          f"found {len(got)} of {len(truth)}, max |err| {max(errs):.2e} "
          f"(oracle {fb['oracle']:.0e}); {status['outerIter'] + 1} outer "
          f"iterations, {report['solves']} lane solves, "
          f"{report['iterations']} MINRES iterations, {report['matmats']} "
          f"passes of {fb['nc'] * fb['m0']} lanes ({unconv} warnings); wall "
          f"{wall:.2f} s, {wall / report['matmats'] * 1e3:.4f} ms/pass",
          flush=True)
    require(len(got) >= len(truth) and max(errs) < fb["oracle"],
            f"{tag}: found {len(got)}, max err {max(errs):.2e}")
    require(Y[0].array.is_cuda, f"{tag}: Ritz vectors left the card")
    check_counts(tag, counts, {})
    walls[tag] = wall

    # (i): bench.py's Chebyshev window task (bench_chebyshev) on (g)'s
    # matrix and guesses, f32 on the card: every filter step one cuBLAS
    # product of the m0 lanes; run twice (the first warms cuBLAS)
    tag = "(i) dense Chebyshev"
    A32 = DenseOperator(np.asarray(Hg).astype(np.float32), device=dev)
    for attempt in range(2):
        (ev, Y, status), wall, counts, _ = run(
            chebyshevFilteredDiagonalization, A32,
            [TorchVector(torch.as_tensor(Yg[:, i], dtype=torch.float32,
                                         device=dev))
             for i in range(fb["m0"])],
            None, fb["eMin"], fb["eMax"], CHEB_BENCH["eConv"],
            CHEB_BENCH["maxit"],
            specBounds=(float(evg[0]) - 1.0, float(evg[-1]) + 1.0),
            writeOut=False)
        got = np.sort(select_within_range(np.asarray(ev), fb["eMin"],
                                          fb["eMax"])[0])
        errs = [float(np.min(np.abs(got - t))) if len(got) else 9e9
                for t in truth]
        print(f"[slice {tag}] n={fb['n']} window [{fb['eMin']}, "
              f"{fb['eMax']}], m0 {fb['m0']}: found {len(got)} of "
              f"{len(truth)}, max |err| {max(errs):.2e} (oracle "
              f"{CHEB_BENCH['oracle']:.0e}); degree {status['degree']}, "
              f"{status['outerIter'] + 1} outer iterations, converged "
              f"{status['isConverged']}; wall {wall:.3f} s (run "
              f"{attempt + 1})",
              flush=True)
        require(len(got) >= len(truth) and max(errs) < CHEB_BENCH["oracle"],
                f"{tag}: found {len(got)}, max err {max(errs):.2e}")
        require(Y[0].array.is_cuda, f"{tag}: Ritz vectors left the card")
        check_counts(tag, counts, {})
    walls[tag] = wall

    # (h0): the contraction kernel of the grouped apply at the benchmark
    # cell's shapes
    t0 = time.perf_counter()
    sop_roles = sop_kernel_roles(dev)
    sop_pairs = sop_pair_role(dev)
    print(f"[sop kernel] (h0) {time.perf_counter() - t0:.1f} s", flush=True)

    # (h): the CH3CN 6-mode cut of bench_sop: the grouped apply in f64 and
    # f32, fused at 256 and not, against a numpy apply of the same groups
    t0 = time.perf_counter()
    ch = CH3CN
    sops = {}
    for name, dtype, fuse in (("f64", np.float64, None),
                              ("f64 fused", np.float64, ch["fuse"]),
                              ("f32", np.float32, None),
                              ("f32 fused", np.float32, ch["fuse"])):
        sops[name], spec, _ = ch3cn_operator(N=ch["N"], nModesCut=ch["cut"],
                                             dtype=dtype, fuse=fuse,
                                             device=dev)
    opu = sops["f64"]
    n = opu.shape[0]
    groups = [(m, [f.cpu().numpy() for f in facs]) for m, facs in opu.groups]
    idc = float(opu.id_coeff)
    t_setup = time.perf_counter() - t0
    x32 = np.random.RandomState(2).rand(n).astype(np.float32)
    t0 = time.perf_counter()
    y64 = np_sop_apply(groups, idc, opu.dims, x32, np.float64)
    t_np64 = time.perf_counter() - t0
    t0 = time.perf_counter()
    y32h = np_sop_apply(groups, idc, opu.dims, x32, np.float32)
    t_np32 = time.perf_counter() - t0
    floor32 = float(np.max(np.abs(y32h.astype(np.float64) - y64)))
    ymax = float(np.max(np.abs(y64)))
    # useful flops: the physical-mode grouped apply (bench.py's count)
    uflops = 2 * n + sum(2 * facs[0].shape[0] * f.shape[1] * n
                         for _, facs in groups for f in facs)
    print(f"[sop] CH3CN N={ch['N']} cut {ch['cut']}: n={n}, "
          f"{len(spec.terms)} terms in {len(groups)} support groups, dims "
          f"{opu.dims}, fused dims {sops['f64 fused'].dims} in "
          f"{len(sops['f64 fused'].groups)} groups; setup {t_setup:.2f} s, "
          f"numpy apply f64 {t_np64:.2f} s, f32 {t_np32:.2f} s; max |y| "
          f"{ymax:.4e}, numpy f32 floor {floor32:.3e}", flush=True)
    sop_ms = {}
    for name, sop in sops.items():
        dtype = torch.float64 if name.startswith("f64") else torch.float32
        x = torch.as_tensor(x32, device=dev).to(dtype)
        err = float(np.max(np.abs(sop.matvec(x).double().cpu().numpy()
                                  - y64)))
        sop_ms[name] = time_ms(lambda: sop.matvec(x), reps=10, warmup=2)
        tol = 1e-10 * ymax if dtype == torch.float64 else 3 * floor32 + 1e-10
        print(f"[sop] {name} apply: {sop_ms[name]:.3f} ms (CUDA events, "
              f"median of 10), {uflops / sop_ms[name] / 1e6:.1f} useful "
              f"GFLOP/s; max |y - y_numpy64| {err:.3e} (tol {tol:.3e})",
              flush=True)
        require(np.isfinite(err) and err <= tol,
                f"(h) {name} apply error {err:.3e} > {tol:.3e}")
    del y64, y32h
    # Lanczos in f64 on the faster f64 form, sigma below the bottom
    form = min(("f64", "f64 fused"), key=sop_ms.get)
    lop = sops[form]
    del sops
    v = torch.as_tensor(np.random.RandomState(4).rand(n), device=dev)
    for _ in range(30):                       # ||H|| from below
        w = lop.matvec(v)
        hn_sop = float(torch.linalg.vector_norm(w)
                       / torch.linalg.vector_norm(v))
        v = w / torch.linalg.vector_norm(w)
    zpve = 0.5 * sum(spec.parameters[f"w{i + 1}"] for i in range(ch["cut"]))
    sig_h = zpve - float(unit2au(500.0, "cm-1"))
    G = 1e-3 * np.random.RandomState(5).standard_normal(
        (len(ch["guesses"]), n))
    for row, excited in zip(G, ch["guesses"]):
        # one quantum in each listed mode: the product basis is row-major
        row[sum(ch["N"] ** (ch["cut"] - 1 - d) for d in excited)] += 1.0
    G = np.linalg.qr(G.T)[0].T
    report = {}
    hopts = {"linearSystemArgs": dict(CH3CN_LINEAR, report=report)}
    tag = "(h) CH3CN Lanczos"
    sop_ops.reset_launch_counts()
    (ev, Y, status), wall, counts, unconv = run(
        inexactLanczosDiagonalization, lop,
        [TorchVector(torch.as_tensor(g, device=dev), hopts) for g in G],
        sig_h, writeOut=False, **CH3CN_LANCZOS)
    sop_launches = sop_ops.launches["sop_contract"]
    pair_launches = sop_ops.launches["sop_pair"]
    require(sop_launches > 0, f"{tag}: no sop_contract launch")
    require(pair_launches > 0, f"{tag}: no sop_pair launch")
    ev = np.asarray(ev)
    picks = np.argsort(ev)[:len(G)]
    ress = []
    for k in picks:
        vk = Y[k].array
        require(vk.dtype == torch.float64 and bool(torch.isfinite(vk).all()),
                f"{tag}: bad Ritz vector {vk.dtype}")
        r = lop.matvec(vk) - ev[k] * vk
        ress.append(float(torch.linalg.vector_norm(r)
                          / torch.linalg.vector_norm(vk)) / hn_sop)
    cm = [float(au2unit(ev[k], "cm-1")) for k in picks]
    print(f"[sop {tag}] N={ch['N']} ({form}), nBlock {len(G)}, sigma "
          f"{float(au2unit(sig_h, 'cm-1')):.3f} cm-1 (harmonic zpve - 500); "
          f"lowest Ritz {', '.join(f'{e:.4f}' for e in cm)} cm-1; "
          f"||Hv-lv||/||H|| {', '.join(f'{e:.2e}' for e in ress)} "
          f"(tol {RES_TOL:.0e}, ||H|| >= {hn_sop:.4e}); converged "
          f"{status['isConverged']} after {status['cumIter']} Krylov steps, "
          f"{report['solves']} solves, {report['iterations']} MINRES "
          f"iterations, {report.get('matmats', 0)} lane-stack and "
          f"{report.get('matvecs', 0)} single applies ({unconv} warnings), "
          f"{sop_launches} sop_contract and {pair_launches} sop_pair "
          f"launches; wall {wall:.2f} s",
          flush=True)
    require(max(ress) <= RES_TOL, f"{tag}: residual {max(ress):.2e}")
    require(Y[0].array.is_cuda, f"{tag}: Ritz vectors left the card")
    check_counts(tag, counts, {})
    walls[tag] = wall
    print(f"[slice] peak device memory of the BSR runs {peak_gb:.3f} GB; "
          f"host read of one device scalar {host_read_us:.1f} us (one per "
          f"MINRES iteration); walls: " + ", ".join(
              f"{k} {v:.2f} s" for k, v in walls.items()), flush=True)
    for k, v in totals.items():
        require(v > 0, f"{k} was never launched by the main path")

    # (l), (m): the CH3CN tree ladder through the ported excited driver;
    # tensor-network contractions through torch (cuBLAS, cuSOLVER), no BSR
    # kernel.  The example drivers write under build/ (their --out),
    # emptied first: a rung found in the output's own log would be skipped
    drivers_out = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(drivers_out, ignore_errors=True)
    bsr.reset_launch_counts()
    t0 = time.perf_counter()
    tree_walls = tree_ladder(dev, os.path.join(drivers_out, "tree"))
    require(not any(bsr.launches.values()),
            f"(l), (m) launched BSR kernels: {dict(bsr.launches)}")
    print(f"[tree] phases (l), (m) {time.perf_counter() - t0:.2f} s: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in tree_walls.items()),
          flush=True)

    # (n0): row-block launches (checks; the counters are zeroed after)
    t0 = time.perf_counter()
    rect_rows = row_blocks(op32, op64, op_high, dev)
    bsr.reset_launch_counts()
    print(f"[n0] {time.perf_counter() - t0:.2f} s", flush=True)

    # (n): the sharded backend on NCCL, one process of world size 1
    store = tempfile.mkdtemp(prefix="chip_smoke_store")
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh()
        require(mesh.device.type == "cuda" and dist.get_backend() == "nccl"
                and mesh.shape == {"b": 1, "x": 1}, f"(n) mesh {mesh}")
        sop32 = shard_operator(op32, mesh)
        require(isinstance(sop32.local, bsr.BSROperator)
                and sop32.local.dataT.data_ptr() == op32.dataT.data_ptr(),
                "(n) the row block of one rank is not the slice's blocks")

        def svectors(rows, report):
            opts = {"linearSystemArgs": dict(LINEAR, report=report)}
            return [ShardedVector(torch.as_tensor(r, dtype=torch.float32,
                                                  device=dev), opts,
                                  mesh=mesh) for r in rows]

        for tag, ref_tag, fn, args, kw, want in (
                ("(n1) sharded highest, nBlock 1", "highest, nBlock 1",
                 inexactLanczosDiagonalization, lambda r: (
                     sop32, svectors(block[:1], r)[0], sigma),
                 dict(writeOut=False, **LANCZOS),
                 [float(levels[TARGET_LEVEL])]),
                ("(n2) sharded fast highest, nBlock 2",
                 "(a) fast highest, nBlock 2", fastLanczosDiagonalization,
                 lambda r: (sop32, svectors(block, r), sigma, LANCZOS["L"],
                            LANCZOS["maxit"], LANCZOS["eConv"]), {},
                 nearest(NBLOCK))):
            report = {}
            call_args = args(report)
            reset_collective_counts()
            (ev, Y, status), wall, counts, unconv = run(fn, *call_args, **kw)
            coll = collective_counts()
            ev_ref, st_ref, rep_ref = refs[ref_tag]
            ev = np.asarray(ev)
            require(isinstance(Y[0], ShardedVector) and Y[0].mesh is mesh,
                    f"{tag}: results are not sharded vectors on the mesh")
            require(status["cumIter"] == st_ref["cumIter"]
                    and report["iterations"] == rep_ref["iterations"]
                    and report.get("matvecs") == rep_ref.get("matvecs")
                    and report.get("matmats") == rep_ref.get("matmats"),
                    f"{tag}: {status['cumIter']} steps, {report}; the "
                    f"unsharded run: {st_ref['cumIter']} steps, {rep_ref}")
            rel = float(np.max(np.abs(ev - ev_ref) / np.abs(ev_ref))) \
                if ev.shape == ev_ref.shape else np.inf
            require(rel <= SHARDED_RTOL, f"{tag}: levels differ from the "
                    f"unsharded run's by {rel:.2e} relative")
            check_states(tag, "highest", ev, Y, want)
            report_line(tag, status, report, wall, unconv)
            if fn is fastLanczosDiagonalization:
                check_counts(tag, counts, {"bsr_spmm": report["matmats"]})
            else:
                extends = status["timers"]["extend_subspace"]["calls"]
                check_counts(tag, counts, {
                    "bsr_spmv": report["matvecs"] + extends,
                    "bsr_spmm": 1 + status["restarts"]})
            steps = status["cumIter"]
            per_step = {k: round(v / steps, 1) for k, v in coll.items()
                        if v}
            print(f"[n] {tag}: the unsharded run's {steps} steps and "
                  f"{report['iterations']} MINRES iterations; levels "
                  f"within {rel:.1e} relative of it; wall {wall:.2f} s "
                  f"(unsharded {walls[ref_tag]:.2f} s); launches "
                  f"{ {k: v for k, v in counts.items() if v} }; collectives "
                  f"{ {k: v for k, v in coll.items() if v} }, per step "
                  f"{per_step}", flush=True)
            walls[tag] = wall
            for k, v in counts.items():
                totals[k] += v

        # (p): the entry points on the card
        t0 = time.perf_counter()
        bsr.reset_launch_counts()
        fn, args = graft_entry.entry()
        out = fn(*args)
        torch.cuda.synchronize()
        nv = out.new_vectors
        norms = torch.linalg.vector_norm(nv.double(), dim=1).cpu().numpy()
        require(nv.is_cuda and bool(torch.isfinite(nv).all())
                and np.all(np.abs(norms - 1) < 1e-3),
                f"(p) entry(): new vectors {tuple(nv.shape)} norms {norms}")
        dry = graft_entry.dryrun_multichip(1)
        audit = graft_entry.weak_scaling(1)
        torch.cuda.synchronize()
        for k, v in bsr.launches.items():
            totals[k] += v
        pins = graft_entry._COLLECTIVE_BUDGET
        for kind, rows in audit.items():
            row = rows[1]
            got = {part: {k: v for k, v in row[part].items() if v}
                   for part in ("per_pass", "one_shot")}
            require(got == pins[kind], f"(p) weak_scaling(1) {kind}: {got}, "
                    f"the CPU tests pin {pins[kind]} at 2 and 4 ranks")
            print(f"[p] weak_scaling(1) {kind} (n = {row['n']}): per MINRES "
                  f"pass {got['per_pass']}, once per step {got['one_shot']} "
                  f"(the CPU tests' pins at 2 and 4 gloo ranks); step wall "
                  f"{row['wall_ms']:.3f} ms, one all-reduce "
                  f"{row['collective_ms']:.4f} ms", flush=True)
        print(f"[p] entry(): step on the CH3CN cut (n = "
              f"{args[1].shape[1]}), new-vector norms {norms}; "
              f"dryrun_multichip(1): mesh {dry['mesh']}, FEAST levels "
              f"{dry['feast_ev']}; {time.perf_counter() - t0:.2f} s",
              flush=True)
    finally:
        dist.destroy_process_group()

    # the slice's operators go before the examples and the flagship, whose
    # N = 42 rung alone holds ~70 GB at its peak
    del op32, op64, op_high, sop32, refs, block
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[q] {torch.cuda.memory_allocated() / 1e9:.3f} GB still "
          f"allocated before (q) and (r)", flush=True)

    # (q): the ported example drivers; no BSROperator among them, so no BSR
    # kernel may launch
    bsr.reset_launch_counts()
    t0 = time.perf_counter()
    ex_walls = run_examples(dev, os.path.join(drivers_out, "examples"))
    require(not any(bsr.launches.values()),
            f"(q) launched BSR kernels: {dict(bsr.launches)}")
    print(f"[q] phase {time.perf_counter() - t0:.2f} s; no BSR kernel "
          f"launched; walls: " + ", ".join(f"{k} {v:.2f} s"
                                           for k, v in ex_walls.items()),
          flush=True)

    # (r): the flagship's N = 42 rung
    bsr.reset_launch_counts()
    t0 = time.perf_counter()
    flagship(dev, os.path.join(drivers_out, "flagship"))
    require(not any(bsr.launches.values()),
            f"(r) launched BSR kernels: {dict(bsr.launches)}")
    print(f"[r] phase {time.perf_counter() - t0:.2f} s", flush=True)

    # (s): the last example drivers and the tool, after (r)'s memory is
    # freed; chain and tree sweeps, dense eigvalsh: no BSR kernel
    gc.collect()
    torch.cuda.empty_cache()
    bsr.reset_launch_counts()
    t0 = time.perf_counter()
    s_walls = last_examples(dev, os.path.join(drivers_out, "last"))
    require(not any(bsr.launches.values()),
            f"(s) launched BSR kernels: {dict(bsr.launches)}")
    print(f"[s] phase {time.perf_counter() - t0:.2f} s; no BSR kernel "
          f"launched; walls: " + ", ".join(f"{k} {v:.2f} s"
                                           for k, v in s_walls.items()),
          flush=True)
    for r in rect_rows:
        print(f"[row] {r['name']} m={r['m']} rows [0, 512) of 2048 (whole "
              f"x): kernel {r['ms']:.4f} ms"
              + (f" (device {ms_or_none(r['device_ms'])})"
                 if r["name"].startswith("bsr_spmv ") else "")
              + f", bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), plain {r['plain_ms']:.4f} ms, library "
              + (f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None
                 else "none") + f" [{r['library']}]", flush=True)

    # -- 5. results ---------------------------------------------------------
    src = "eigensolvers_tpu_torch/csrc/"
    b3 = "eigensolvers_tpu/ops/sparse.py:294 (_bsr_matmat_xla, XLA)"
    b3_high = ("eigensolvers_tpu/ops/sparse.py:295 (_bsr_matmat_xla at "
               "HIGH, XLA, via _bsr_matvec_best_split's vmap rule :525)")

    def entry(name, source, replaces, key):
        r = results[key]
        kname, m = key if isinstance(key, tuple) else (key, 1)
        return dict(name=name, route="cuda", source=src + source,
                    replaces=replaces, launches=totals[name],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"],
                    library=r["library"], units=units(kname, m),
                    share=r["bound_ms"] / r["ms"], device_ms=r["device_ms"])

    def b3_entry(kind, m, run):
        """B3 at the lane count of run (f) or (k), with its launches
        there."""
        dt = torch.float32 if kind == "f32" else torch.float64
        return dict(entry("bsr_spmm", "bsr_spmm.cu", b3,
                          (f"bsr_spmm {kind}", m)),
                    name=f"bsr_spmm {kind} m={m}",
                    launches=b3_shapes[(dt, m)], run=run)

    line = {"kernels": [
        # B1: B3's kernel launched with one vector
        entry("bsr_spmv", "bsr_spmm.cu",
              "eigensolvers_tpu/ops/sparse.py:440", "bsr_spmv f32"),
        entry("bsr_spmv_split", "bsr_spmm_split.cu",
              "eigensolvers_tpu/ops/sparse.py:479", "bsr_spmv_split"),
        # B3 at the main path's lane count (the block of two), and at the
        # 64 f32 lanes of (f) and the 48 f64 lanes of (k)
        entry("bsr_spmm", "bsr_spmm.cu", b3, ("bsr_spmm f32", NBLOCK)),
        b3_entry("f32", F_LANES, "(f)"),
        b3_entry("f64", 48, "(k)"),
        entry("bsr_spmm_split", "bsr_spmm_split.cu", b3_high,
              ("bsr_spmm_split", NBLOCK)),
        # the split form at the 64 lanes of (t), with its launches there
        dict(entry("bsr_spmm_split", "bsr_spmm_split.cu", b3_high,
                   ("bsr_spmm_split", F_LANES)),
             name=f"bsr_spmm_split m={F_LANES}", launches=split_launches,
             run="(t)"),
        # the SoP contraction's fan-in at the benchmark cell's shape (one
        # lane, 14 terms, mode 3), with its launches in (h)
        dict(name="sop_contract", route="cuda",
             source=src + "sop_contract.cu",
             replaces="none (the JAX package left the SoP apply to XLA)",
             launches=sop_launches, run="(h)", bound_by="bytes",
             share=(sop_roles[("fan-in", 1, 14, 3)]["bound_ms"]
                    / sop_roles[("fan-in", 1, 14, 3)]["ms"]),
             **sop_roles[("fan-in", 1, 14, 3)]),
        # its pair role at the cell's largest pair (three lanes, modes 1
        # and 3, five terms), with its launches in (h)
        dict(name="sop_pair", route="cuda", source=src + "sop_contract.cu",
             replaces="none (the JAX package left the SoP apply to XLA)",
             launches=pair_launches, run="(h)",
             bound_by=("bytes" if sop_pairs[(3, (1, 3))]["bytes_ms"]
                       >= sop_pairs[(3, (1, 3))]["flops_ms"] else "flops"),
             share=(sop_pairs[(3, (1, 3))]["bound_ms"]
                    / sop_pairs[(3, (1, 3))]["ms"]),
             **sop_pairs[(3, (1, 3))]),
    ]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
