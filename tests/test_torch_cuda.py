"""The hand-written CUDA kernels (B1 and B2 single-vector SpMV, B3
multi-vector; B2 and B3's bf16x3 form are one tensor-core kernel) against
their plain PyTorch versions, on the card.  Marked ``cuda``: without a CUDA
device every test here skips.  Run them on a machine with an NVIDIA Hopper
GPU and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from eigensolvers_tpu_torch.ops import sparse as bsr

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(nrb, nbpr, B, dtype, dev, seed=0):
    rng = np.random.RandomState(seed)
    dataT = torch.as_tensor(rng.standard_normal((nrb, nbpr, B, B)),
                            dtype=dtype, device=dev)
    idx = torch.as_tensor(rng.randint(0, nrb, (nrb, nbpr)), dtype=torch.int32,
                          device=dev)
    x = torch.as_tensor(rng.standard_normal(nrb * B), dtype=dtype, device=dev)
    return dataT, idx, x


def _relerr(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


# Shapes: ragged nrb (not a multiple of 8), odd nbpr, B from one warp to the
# 1024-thread limit, including B that is not a multiple of 32.
SHAPES = [(5, 3, 32), (5, 3, 64), (3, 1, 128), (7, 5, 100), (2, 2, 1024)]

# The split kernels against the exact bf16x3 product (the same products
# summed in f64), two ways.  Max error relative to max |y|: their f32
# summation order alone, which grows with the N = nbpr * B terms of a row:
# 2e-6 up to N = 1152, where a true-f32 product reads 3.5e-6 and more;
# 5e-6 at N = 2048, where the roundoff itself reaches 3.5e-6.  Signature:
# |t| <= 0.1 for the kernels, |1 - t| <= 0.1 for a true-f32 product, at
# every N (PERF.md gives the readings on the card).
SIG_TOL = 0.1


def _split_tol(nbpr, B):
    return 2e-6 if nbpr * B <= 1152 else 5e-6


def _signature(y, exact, y64):
    """t = <y - exact, d> / <d, d> with d = y64 - exact, the split's own
    error: ~0 for a bf16x3 product, ~1 for a true-f32 product."""
    d = y64 - exact
    return float(((y.double() - exact) * d).sum() / (d * d).sum())


@pytest.mark.parametrize("nrb,nbpr,B", SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_bsr_spmv_matches_plain(dev, nrb, nbpr, B, dtype, tol):
    """B1 against the gather+einsum version in the same type; the bound is
    summation-order roundoff over nbpr*B terms."""
    dataT, idx, x = _case(nrb, nbpr, B, dtype, dev)
    bsr.reset_launch_counts()
    y = bsr.bsr_matvec(dataT, idx, x)
    torch.cuda.synchronize()
    assert bsr.launches["bsr_spmv"] == 1
    assert _relerr(y, bsr.bsr_matvec_plain(dataT, idx, x)) <= tol


# B1 is B3's kernel with one vector (the one-lane tile of
# csrc/bsr_spmm.cu): a CTA per block row and 128 output rows (B > 128 as
# more CTAs on the grid's y axis), each block streamed in slabs of KS rows j
# (64 in f32, 32 in f64) through a two-slot cp.async ring, with 16-byte
# copies where B and the base allow them (B % 4 == 0 in f32, B % 2 == 0 in
# f64) and narrower ones otherwise.  Each case: B off the 16-byte route (1,
# 3, 5; odd B in f64 too); a partial last slab (B = 100 and 48 in both
# types, 96 in f32; 200 also a second CTA of 72 rows); B = 1024 (the
# largest, 8 CTAs over its rows); nbpr = 1; nrb below the 132 SMs.
B1_EDGES = [(7, 3, 1), (9, 1, 3), (6, 2, 5), (7, 3, 100), (5, 1, 100),
            (6, 2, 96), (5, 3, 48), (4, 2, 200), (3, 1, 1024), (2, 2, 1024)]


def _b1_launch_checks(dataT, idx, x, tol, row_ranges):
    """B1 against the plain version; a second launch bit for bit the first;
    each row block [r0, r1) with the whole x bit for bit the square
    launch's rows."""
    nrb, _, B, _ = dataT.shape
    bsr.reset_launch_counts()
    y = bsr.bsr_matvec(dataT, idx, x)
    y2 = bsr.bsr_matvec(dataT, idx, x)
    torch.cuda.synchronize()
    assert bsr.launches["bsr_spmv"] == 2
    assert _relerr(y, bsr.bsr_matvec_plain(dataT, idx, x)) <= tol
    assert torch.equal(y, y2)
    for r0, r1 in row_ranges:
        yr = bsr.bsr_matvec(dataT[r0:r1], idx[r0:r1], x, ncb=nrb)
        torch.cuda.synchronize()
        assert torch.equal(yr, y[r0 * B:r1 * B])


@pytest.mark.parametrize("nrb,nbpr,B", B1_EDGES)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_bsr_spmv_at_the_ring_edges(dev, nrb, nbpr, B, dtype, tol):
    dataT, idx, x = _case(nrb, nbpr, B, dtype, dev, seed=B + nbpr)
    _b1_launch_checks(dataT, idx, x, tol,
                      [(0, 1), (nrb - 1, nrb), (1, nrb)])


# nrb far above the SM count: many more block rows (CTAs) than the card
# holds at once, so the grid runs in waves; row blocks of one row, of a
# ragged range and of all but the first.
@pytest.mark.parametrize("nrb,nbpr,B", [(5000, 3, 32), (1500, 2, 128),
                                        (2000, 1, 100)])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_bsr_spmv_runs_block_rows_in_many_waves(dev, nrb, nbpr, B, dtype,
                                                tol):
    dataT, idx, x = _case(nrb, nbpr, B, dtype, dev, seed=nrb)
    _b1_launch_checks(dataT, idx, x, tol,
                      [(nrb // 2, nrb // 2 + 1), (13, nrb - 7), (1, nrb)])


@pytest.mark.parametrize("nrb,nbpr,B,offset", [
    (4, 3, 128, 1),      # blocks and x not 16-byte aligned: elements
    (5, 2, 100, 2),      # f64: 16-byte aligned again, f32 8-byte copies
    (3, 2, 6, 0)])       # B = 6: 8-byte copies in f32, 16-byte in f64
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_bsr_spmv_takes_any_alignment(dev, nrb, nbpr, B, offset, dtype, tol):
    """B1 on blocks and x placed ``offset`` elements into their buffers
    (the copy width follows the addresses), against the plain version, and
    bit for bit the same values as on aligned copies (every copy width
    feeds the same sums in one order)."""
    dataT, idx, x = _case(nrb, nbpr, B, dtype, dev, seed=offset)

    def placed(t):
        buf = torch.zeros(t.numel() + offset, dtype=dtype, device=dev)
        buf[offset:] = t.reshape(-1)
        return buf[offset:].view(t.shape)

    y = bsr.bsr_matvec(placed(dataT), idx, placed(x))
    torch.cuda.synchronize()
    assert _relerr(y, bsr.bsr_matvec_plain(dataT, idx, x)) <= tol
    assert torch.equal(y, bsr.bsr_matvec(dataT, idx, x))


@pytest.mark.parametrize("nrb,nbpr,B", SHAPES)
def test_bsr_spmv_split_matches_plain_and_f64(dev, nrb, nbpr, B):
    """B2 against its plain version summed in f64, the exact bf16x3 product
    (only the kernel's f32 summation order differs), and against the f64
    product of the f32 data (the method's error, ≤1e-5).  Its signature
    tells it from a true-f32 product, whose signature is checked too."""
    dataT, idx, x = _case(nrb, nbpr, B, torch.float32, dev, seed=1)
    hi = dataT.to(torch.bfloat16)
    lo = (dataT - hi.float()).to(torch.bfloat16)
    bsr.reset_launch_counts()
    y = bsr.bsr_matvec_split(hi, lo, idx, x)
    torch.cuda.synchronize()
    assert bsr.launches["bsr_spmv_split"] == 1
    exact = bsr.bsr_matvec_split_plain(hi, lo, idx, x, acc=torch.float64)
    assert _relerr(y, exact) <= _split_tol(nbpr, B)
    y64 = bsr.bsr_matvec_plain(dataT.double(), idx, x.double())
    assert _relerr(y, y64) <= 1e-5
    assert abs(_signature(y, exact, y64)) <= SIG_TOL
    y32 = bsr.bsr_matvec(dataT, idx, x)
    assert abs(1 - _signature(y32, exact, y64)) <= SIG_TOL


# Lane counts of B3 (bsr_spmm): one CTA of each tile up to 32 lanes (1, 2,
# 4, 8, 16, 32), partial tiles (3, 9, 17, 31); above 32 the 48- and 64-lane
# tiles (the FP64 tensor cores in f64, the 8-row FMA tiles in f32) at and
# around their edges (33, 47, 48, 49, 63, 64, 65) and the chunks of 64
# (96, 128, and 129, whose last chunk holds one lane).  The tensor-core
# split kernel takes 8, 16, 32, 48 or 64 lanes per CTA and runs chunks of
# equal width beyond 64 (SPLIT_EDGE_LANES: the edges of its tiles and
# chunks, 65 = 2 x 33 and 129 = 3 x 43 among them).
LANES = [1, 2, 3, 4, 8, 9, 16, 17, 31, 32, 33, 47, 48, 49, 63, 64, 65, 96,
         128, 129]
SPLIT_LANES = [1, 2, 3, 4, 8, 9, 17, 33]
SPLIT_EDGE_LANES = [33, 47, 63, 64, 65, 95, 127, 128, 129, 200]


def _lanes(nrb, B, m, dtype, dev, seed):
    rng = np.random.RandomState(seed)
    return torch.as_tensor(rng.standard_normal((m, nrb * B)), dtype=dtype,
                           device=dev)


@pytest.mark.parametrize("m", LANES)
@pytest.mark.parametrize("nrb,nbpr,B", SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_bsr_spmm_matches_plain(dev, nrb, nbpr, B, m, dtype, tol):
    """B3 against the gather+einsum version in the same type, one launch
    for all m lanes; the bound is summation-order roundoff as for B1."""
    dataT, idx, _ = _case(nrb, nbpr, B, dtype, dev)
    X = _lanes(nrb, B, m, dtype, dev, seed=m)
    bsr.reset_launch_counts()
    Y = bsr.bsr_matmat(dataT, idx, X)
    torch.cuda.synchronize()
    assert bsr.launches["bsr_spmm"] == 1
    assert _relerr(Y, bsr.bsr_matmat_plain(dataT, idx, X)) <= tol


@pytest.mark.parametrize("m", [32, 64])
@pytest.mark.parametrize("nrb,nbpr,B", SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_bsr_spmm_edge_lanes_match_bsr_spmv(dev, nrb, nbpr, B, m, dtype,
                                            tol):
    """Rows 0 and m - 1 of a 32- and a 64-lane product (the first and last
    lane of one tile of 32, and of the 64-lane tile) against B1 on those
    lanes: two summation orders, the bound of the B3 test above."""
    dataT, idx, _ = _case(nrb, nbpr, B, dtype, dev, seed=5)
    X = _lanes(nrb, B, m, dtype, dev, seed=6)
    Y = bsr.bsr_matmat(dataT, idx, X)
    for k in (0, m - 1):
        y = bsr.bsr_matvec(dataT, idx, X[k].contiguous())
        torch.cuda.synchronize()
        assert _relerr(Y[k], y) <= tol


@pytest.mark.parametrize("m", [8, 32, 48, 64, 129])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_bsr_spmm_is_deterministic(dev, m, dtype):
    """Two launches on the same inputs give the same Y bit for bit: each
    sum runs in a fixed order, with no atomics and no split over j."""
    dataT, idx, _ = _case(7, 5, 100, dtype, dev, seed=8)
    X = _lanes(7, 100, m, dtype, dev, seed=9)
    Y1 = bsr.bsr_matmat(dataT, idx, X)
    Y2 = bsr.bsr_matmat(dataT, idx, X)
    torch.cuda.synchronize()
    assert torch.equal(Y1, Y2)


@pytest.mark.parametrize("m", [1, 9, 33, 48, 64, 129])
@pytest.mark.parametrize("nrb,nbpr,B,offset", [
    (4, 2, 7, 0),        # odd B: element copies, a partial chunk of rows j
    (3, 3, 50, 0),       # B % 4 == 2: 8-byte copies in f32
    (3, 2, 100, 1),      # blocks and X not 16-byte aligned: element copies
    (2, 2, 200, 0),      # B > 128: two CTAs of output rows, one partial
    (3, 2, 1, 0)])       # one-element blocks
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_bsr_spmm_takes_any_width_and_alignment(dev, nrb, nbpr, B, offset, m,
                                                dtype, tol):
    """B3's narrower copies, partial slabs and partial tiles against the
    plain product, with the bound of the B3 test above; ``offset`` places
    both the blocks and the lane stack that many elements into their
    buffers."""
    dataT, idx, _ = _case(nrb, nbpr, B, dtype, dev, seed=B)
    X = _lanes(nrb, B, m, dtype, dev, seed=m)

    def placed(t):
        buf = torch.zeros(t.numel() + offset, dtype=dtype, device=dev)
        buf[offset:] = t.reshape(-1)
        return buf[offset:].view(t.shape)

    dataT_o, X_o = placed(dataT), placed(X)
    assert (dataT_o.data_ptr() % 16 == 0) == (offset == 0)
    assert (X_o.data_ptr() % 16 == 0) == (offset == 0)
    Y = bsr.bsr_matmat(dataT_o, idx, X_o)
    torch.cuda.synchronize()
    assert _relerr(Y, bsr.bsr_matmat_plain(dataT, idx, X)) <= tol


@pytest.mark.parametrize("m", SPLIT_LANES)
@pytest.mark.parametrize("nrb,nbpr,B", SHAPES)
def test_bsr_spmm_split_matches_plain_and_f64(dev, nrb, nbpr, B, m):
    """B3 at "high" against its plain version summed in f64, the exact
    bf16x3 product, as B2, and row k against B2 on lane k (two f32
    summation orders, the same bound).  Its signature tells it from a
    true-f32 product.  Against the f64 product of the f32 data the bound is
    the method's own, element by element, as on the CPU
    (tests/test_torch_sparse.py): |y - y64| <= 1e-5 · (|A| |X|)."""
    dataT, idx, _ = _case(nrb, nbpr, B, torch.float32, dev, seed=1)
    hi = dataT.to(torch.bfloat16)
    lo = (dataT - hi.float()).to(torch.bfloat16)
    X = _lanes(nrb, B, m, torch.float32, dev, seed=m)
    bsr.reset_launch_counts()
    Y = bsr.bsr_matmat_split(hi, lo, idx, X)
    torch.cuda.synchronize()
    assert bsr.launches["bsr_spmm_split"] == 1
    exact = bsr.bsr_matmat_split_plain(hi, lo, idx, X, acc=torch.float64)
    tol = _split_tol(nbpr, B)
    assert _relerr(Y, exact) <= tol
    y64 = bsr.bsr_matmat_plain(dataT.double(), idx, X.double())
    scale = bsr.bsr_matmat_plain(dataT.double().abs(), idx, X.double().abs())
    assert bool(((Y.double() - y64).abs() <= 1e-5 * scale).all())
    for k in (0, m - 1):
        one = bsr.bsr_matvec_split(hi, lo, idx, X[k].contiguous())
        assert _relerr(Y[k], one) <= tol
    assert abs(_signature(Y, exact, y64)) <= SIG_TOL
    Y32 = bsr.bsr_matmat(dataT, idx, X)
    assert abs(1 - _signature(Y32, exact, y64)) <= SIG_TOL


@pytest.mark.parametrize("m", SPLIT_EDGE_LANES)
@pytest.mark.parametrize("nrb,nbpr,B", [(6, 3, 128), (5, 3, 40),
                                        (3, 2, 200)])
def test_split_kernel_at_the_tile_and_chunk_edges(dev, nrb, nbpr, B, m):
    """The split kernel's wide tiles (48, 64 lanes: one read of hi/lo) and
    its chunks beyond 64 lanes, at and around their edges, for B = 128, an
    odd B (40: a partial K-step, warps past B, the mma.sync tiles at every
    m) and B = 200 (two CTAs of output rows, the second partial, and a
    partial K-step on the wgmma route): one launch, the exact split
    product's bound, the signature, and every lane against B2 on that
    lane."""
    dataT, idx, _ = _case(nrb, nbpr, B, torch.float32, dev, seed=2)
    hi = dataT.to(torch.bfloat16)
    lo = (dataT - hi.float()).to(torch.bfloat16)
    X = _lanes(nrb, B, m, torch.float32, dev, seed=m)
    bsr.reset_launch_counts()
    Y = bsr.bsr_matmat_split(hi, lo, idx, X)
    torch.cuda.synchronize()
    assert bsr.launches["bsr_spmm_split"] == 1
    exact = bsr.bsr_matmat_split_plain(hi, lo, idx, X, acc=torch.float64)
    tol = _split_tol(nbpr, B)
    assert _relerr(Y, exact) <= tol
    y64 = bsr.bsr_matmat_plain(dataT.double(), idx, X.double())
    assert abs(_signature(Y, exact, y64)) <= SIG_TOL
    assert abs(1 - _signature(bsr.bsr_matmat(dataT, idx, X), exact, y64)) \
        <= SIG_TOL
    ones = torch.stack([bsr.bsr_matvec_split(hi, lo, idx, x.contiguous())
                        for x in X])
    assert _relerr(Y, ones) <= tol


@pytest.mark.parametrize("m", [1, 33, 64, 65, 129])
@pytest.mark.parametrize("nrb,nbpr,B", [(6, 3, 128), (5, 3, 40),
                                        (3, 2, 200)])
def test_split_kernel_leaves_lanes_past_m_and_rows_past_B_unwritten(
        dev, nrb, nbpr, B, m):
    """A launch into a NaN-filled buffer one lane longer than Y: the m
    lanes equal the wrapper's result bit for bit, and the lane past m
    stays NaN, so no CTA writes a lane past m or a row past B (the last
    block row's rows past B would land there)."""
    from eigensolvers_tpu_torch.ops import kernels
    dataT, idx, _ = _case(nrb, nbpr, B, torch.float32, dev, seed=3)
    hi = dataT.to(torch.bfloat16)
    lo = (dataT - hi.float()).to(torch.bfloat16)
    X = _lanes(nrb, B, m, torch.float32, dev, seed=m)
    buf = torch.full(((m + 1) * nrb * B,), float("nan"), device=dev)
    lib = kernels.bsr_spmm_split_library()
    code = lib.bsr_spmm_split_f32(
        hi.data_ptr(), lo.data_ptr(), idx.data_ptr(), X.data_ptr(),
        buf.data_ptr(), nrb, nrb, nbpr, B, m,
        torch.cuda.current_stream().cuda_stream)
    kernels.check(lib, code, "bsr_spmm_split")
    Y = bsr.bsr_matmat_split(hi, lo, idx, X)
    torch.cuda.synchronize()
    assert torch.equal(buf[:m * nrb * B].view(m, nrb * B), Y)
    assert bool(buf[m * nrb * B:].isnan().all())


def _split_case(nrb, nbpr, B, m, dev, offset=0):
    """hi/lo blocks (starting ``offset`` bf16 elements into their buffers)
    and a lane stack; returns (dataT, hi, lo, idx, X)."""
    dataT, idx, _ = _case(nrb, nbpr, B, torch.float32, dev, seed=B)

    def placed(half):
        buf = torch.zeros(half.numel() + offset, dtype=torch.bfloat16,
                          device=dev)
        buf[offset:] = half.reshape(-1)
        return buf[offset:].view(half.shape)

    hi = dataT.to(torch.bfloat16)
    lo = (dataT - hi.float()).to(torch.bfloat16)
    return (dataT, placed(hi), placed(lo), idx,
            _lanes(nrb, B, m, torch.float32, dev, m))


@pytest.mark.parametrize("m", [1, 9, 65])
@pytest.mark.parametrize("nrb,nbpr,B,offset", [
    (4, 2, 7, 0),        # odd B: element copies, one warp
    (3, 3, 50, 0),       # B % 4 == 2: 4-byte copies
    (3, 2, 100, 1),      # hi/lo not 16-byte aligned: 2-byte copies
    (2, 2, 200, 0),      # B > 128: two CTAs of output rows, one partial
    (3, 2, 1, 0)])       # one-element blocks
def test_split_kernel_takes_any_width_and_alignment(dev, nrb, nbpr, B,
                                                    offset, m):
    """The tensor-core kernel's narrower copies and partial tiles (the
    mma.sync tiles at every m where the wgmma route's 16-byte copies do not
    apply, their chunks beyond 64 lanes too): the same bounds against the
    exact split product as the slice's shapes."""
    dataT, hi, lo, idx, X = _split_case(nrb, nbpr, B, m, dev, offset)
    assert (hi.data_ptr() % 16 == 0) == (offset == 0)
    Y = bsr.bsr_matmat_split(hi, lo, idx, X)
    torch.cuda.synchronize()
    exact = bsr.bsr_matmat_split_plain(hi, lo, idx, X, acc=torch.float64)
    assert _relerr(Y, exact) <= _split_tol(nbpr, B)
    y64 = bsr.bsr_matmat_plain(dataT.double(), idx, X.double())
    assert abs(_signature(Y, exact, y64)) <= SIG_TOL


def test_b2_launches_the_tensor_core_kernel(dev):
    """B2 (one vector at "high") is the split kernel with m = 1, counted as
    bsr_spmv_split: bit for bit the lane stack's result for that vector."""
    _, hi, lo, idx, X = _split_case(7, 5, 128, 1, dev)
    bsr.reset_launch_counts()
    y = bsr.bsr_matvec_split(hi, lo, idx, X[0])
    Y = bsr.bsr_matmat_split(hi, lo, idx, X)
    torch.cuda.synchronize()
    assert bsr.launches["bsr_spmv_split"] == 1
    assert bsr.launches["bsr_spmm_split"] == 1
    assert torch.equal(y, Y[0])


def test_operator_matvec_launches_kernel(dev):
    """BSROperator.matvec on the card goes through B1 ("highest") and B2
    ("high"), including n that is not a multiple of B."""
    rng = np.random.RandomState(2)
    n, B = 300, 64
    H = rng.standard_normal((n, n))
    x = rng.standard_normal(n)
    for prec, key in (("highest", "bsr_spmv"), ("high", "bsr_spmv_split")):
        op = bsr.BSROperator.from_dense(H.astype(np.float32), block_size=B,
                                        precision=prec, device=dev)
        bsr.reset_launch_counts()
        y = op.matvec(torch.as_tensor(x, dtype=torch.float32, device=dev))
        torch.cuda.synchronize()
        assert bsr.launches[key] == 1
        assert np.abs(y.cpu().numpy() - H @ x).max() <= 1e-4 * np.abs(H @ x).max()


def test_operator_lane_apply_launches_b3(dev):
    """BSROperator.matvec_lanes and matmat on the card go through B3 at
    "highest" and its split form at "high": one launch per apply."""
    rng = np.random.RandomState(3)
    n, B, m = 300, 64, 3
    H = rng.standard_normal((n, n))
    X = rng.standard_normal((m, n))
    for prec, key in (("highest", "bsr_spmm"), ("high", "bsr_spmm_split")):
        op = bsr.BSROperator.from_dense(H.astype(np.float32), block_size=B,
                                        precision=prec, device=dev)
        bsr.reset_launch_counts()
        Xt = torch.as_tensor(X, dtype=torch.float32, device=dev)
        Y = op.matvec_lanes(Xt)
        Yc = op.matmat(Xt.T)
        torch.cuda.synchronize()
        assert bsr.launches[key] == 2
        ref = X @ H.T
        for got in (Y.cpu().numpy(), Yc.T.cpu().numpy()):
            assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_wrappers_refuse_what_the_kernel_does_not_take(dev):
    dataT, idx, x = _case(3, 2, 32, torch.float32, dev)
    with pytest.raises(TypeError):
        bsr.bsr_matvec(dataT.half(), idx, x.half())
    with pytest.raises(ValueError):
        bsr.bsr_matvec(dataT, idx.long(), x)
    with pytest.raises(ValueError):
        bsr.bsr_matvec(dataT.transpose(2, 3), idx, x)    # not contiguous
    with pytest.raises(ValueError):
        bsr.bsr_matvec(dataT, idx, x[:-1])
    big = torch.zeros((1, 1, 2048, 2048), device=dev)
    with pytest.raises(ValueError):
        bsr.bsr_matvec(big, idx[:1, :1], torch.zeros(2048, device=dev))
    X = torch.zeros((2, 96), device=dev)
    with pytest.raises(TypeError):
        bsr.bsr_matmat(dataT.double(), idx, X)
    with pytest.raises(ValueError):
        bsr.bsr_matmat(dataT, idx, X[:, :-1])
    with pytest.raises(ValueError):
        bsr.bsr_matmat(dataT, idx, X[:, :0].T)             # no lanes


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-6)])
def test_complex_vectors_on_real_blocks_take_b3(dev, precision, dtype, tol):
    """A complex x or lane stack on a real BSROperator on the card: its real
    and imaginary parts as 2m real lanes of ONE B3 launch (the split form
    at "high" on f32 data, held at 2e-5 against f64 like B3's split
    lanes), equal to to_dense() @ x; the blocks stay real."""
    rng = np.random.RandomState(7)
    n, B = 5 * 32 - 9, 32
    H = rng.standard_normal((n, n))
    op = bsr.BSROperator.from_dense(H.astype(np.float32) if dtype ==
                                    torch.float32 else H, block_size=B,
                                    precision=precision, device=dev)
    cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
    X = torch.as_tensor(rng.standard_normal((3, n))
                        + 1j * rng.standard_normal((3, n)), dtype=cdt,
                        device=dev)
    split = precision == "high" and dtype == torch.float32
    key = "bsr_spmm_split" if split else "bsr_spmm"
    dense = op.to_dense().cpu().numpy().astype(np.complex128)
    bsr.reset_launch_counts()
    y = op.matvec(X[0])
    Y = op.matvec_lanes(X)
    torch.cuda.synchronize()
    assert bsr.launches[key] == 2 and sum(bsr.launches.values()) == 2
    assert op.dataT.dtype == dtype and y.dtype == Y.dtype == cdt
    tol = 2e-5 if split else tol
    Xh = X.cpu().numpy()
    for got, ref in ((y, dense @ Xh[0]), (Y, Xh @ dense.T)):
        got = got.cpu().numpy()
        assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


# ---------------------------------------------------------------------------
# tensor networks on the card (cuBLAS / cuSOLVER through torch; no kernel of
# this package) against the same code on device="cpu", to 1e-9
# ---------------------------------------------------------------------------
TN_DIMS = [3, 2, 3, 3, 3, 5]


def _tn_operator(device):
    from eigensolvers_tpu_torch import SumOfProductOperator
    from eigensolvers_tpu_torch.models.synthetic import random_sop_terms
    terms = random_sop_terms(nDim=6, dims=TN_DIMS, nSum=3, seed=1212)
    return SumOfProductOperator.from_terms(6, TN_DIMS, terms, device=device)


def test_mps_chain_dmrg_and_als_on_the_card(dev):
    """Chain DMRG eigenvalues and an ALS solve on the card equal the CPU
    run's to 1e-9; the states stay on the card."""
    from eigensolvers_tpu_torch.vectors import mps, mps_sweeps
    out = {}
    for d in (torch.device("cpu"), dev):
        W = mps.MPO.from_sop_compressed(_tn_operator(d))
        ev, xs = mps_sweeps.dmrg_eigensolve(W.tensors, TN_DIMS, nStates=2,
                                            maxD=60, nSweep=30,
                                            convTol=1e-13, seed=3)
        b = mps.mps_random(TN_DIMS, 4, seed=9, device=d)
        x = mps_sweeps.als_solve(W.tensors, b, 3.7, maxD=80, eps=1e-12,
                                 nSweep=20, convTol=1e-10, local_tol=1e-10)
        assert all(t.device.type == d.type for t in xs[1] + x)
        out[d.type] = (np.asarray(ev), mps.mps_dense(x).cpu().numpy())
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-9)
    ref = out["cpu"][1]
    assert np.abs(out["cuda"][1] - ref).max() <= 1e-9 * np.abs(ref).max()


def test_ttns_lanczos_on_the_card(dev):
    """Inexact Lanczos on tree states with tree-ALS solves: the card's Ritz
    value nearest sigma equals the CPU run's to 1e-9, and so does the
    zipper sandwich of a fitted state."""
    from eigensolvers_tpu_torch import (find_nearest,
                                        inexactLanczosDiagonalization)
    from eigensolvers_tpu_torch.vectors.ttns import TTNSVector, TreeTopology
    topo = TreeTopology((-1, 0, 0, 2, 2, 4))
    opts = {"compressArgs": {"maxD": 60, "eps": 1e-10},
            "linearSystemArgs": {"method": "als", "nSweep": 10,
                                 "convTol": 1e-10, "siteTol": 1e-10,
                                 "linearIter": 300, "linear_tol": 1e-8,
                                 "maxD": 60, "eps": 1e-10}}
    got = {}
    for d in (torch.device("cpu"), dev):
        op = _tn_operator(d)
        y0 = TTNSVector.random(topo, TN_DIMS, 8, opts, seed=11, device=d)
        ev, uv, _ = inexactLanczosDiagonalization(op, y0, 0.95, 8, 4, 1e-10,
                                                  writeOut=False)
        W = y0._mpo(op)
        k = int(np.argmin(np.abs(np.asarray(ev) - 0.95)))
        assert uv[k].tensors[0].device.type == d.type
        got[d.type] = (find_nearest(ev, 0.95)[1],
                       W.sandwich(uv[k].tensors, uv[k].tensors))
    np.testing.assert_allclose(got["cuda"], got["cpu"], rtol=1e-9)


# Row blocks on the card: the launch of block rows [r0, r1) with the whole
# x (ncb = nrb block columns) must give EXACTLY the rows [r0*B, r1*B) of
# the square launch (each output row is computed the same way), and match
# the plain rectangular version as the square launch does.
@pytest.mark.parametrize("m", [1, 2, 16, 33, 48, 64, 129])
@pytest.mark.parametrize("nrb,nbpr,B", [(8, 3, 32), (6, 2, 128), (5, 3, 100)])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_row_block_launches_equal_the_square_rows(dev, nrb, nbpr, B, m,
                                                  dtype, tol):
    dataT, idx, _ = _case(nrb, nbpr, B, dtype, dev)
    X = _lanes(nrb, B, m, dtype, dev, 5)
    Y = bsr.bsr_matmat(dataT, idx, X)
    y = bsr.bsr_matvec(dataT, idx, X[0].contiguous())
    for r0, r1 in ((0, 2), (2, nrb - 1), (nrb - 1, nrb)):
        d, i = dataT[r0:r1].contiguous(), idx[r0:r1].contiguous()
        Yr = bsr.bsr_matmat(d, i, X, ncb=nrb)
        yr = bsr.bsr_matvec(d, i, X[0].contiguous(), ncb=nrb)
        torch.cuda.synchronize()
        rows = slice(r0 * B, r1 * B)
        assert torch.equal(Yr, Y[:, rows]) and torch.equal(yr, y[rows])
        assert _relerr(Yr, bsr.bsr_matmat_plain(d, i, X)) <= tol


@pytest.mark.parametrize("m", [1, 9, 33, 64, 65, 129])
@pytest.mark.parametrize("nrb,nbpr,B", [(8, 3, 32), (6, 2, 128)])
def test_split_row_block_launches_equal_the_square_rows(dev, nrb, nbpr, B,
                                                        m):
    dataT, idx, _ = _case(nrb, nbpr, B, torch.float32, dev)
    hi = dataT.to(torch.bfloat16)
    lo = (dataT - hi.float()).to(torch.bfloat16)
    X = _lanes(nrb, B, m, torch.float32, dev, 6)
    Y = bsr.bsr_matmat_split(hi, lo, idx, X)
    for r0, r1 in ((0, 3), (3, nrb)):
        h, l_, i = (t[r0:r1].contiguous() for t in (hi, lo, idx))
        Yr = bsr.bsr_matmat_split(h, l_, i, X, ncb=nrb)
        y1 = bsr.bsr_matvec_split(h, l_, i, X[0].contiguous(), ncb=nrb)
        torch.cuda.synchronize()
        assert torch.equal(Yr, Y[:, r0 * B:r1 * B])
        exact = bsr.bsr_matmat_split_plain(h, l_, i, X, acc=torch.float64)
        assert _relerr(Yr, exact) <= _split_tol(nbpr, B)
        assert _relerr(y1, exact[0]) <= _split_tol(nbpr, B)


def test_lanczos_timers_are_the_device_extent_of_their_spans(dev):
    """On the card ``status["timers"]`` are the stream's seconds: each
    Lanczos phase's seconds are, within 2 % or 1 ms, the time the stream
    took over the phase as the trace shows it (from the later of the
    span's start on the host and the end of the work launched before it,
    to the later of its end and the end of the work launched inside it),
    give or take 0.1 ms a call: the host's own work between the span's
    edges and its events, which the trace does not show (the range, the
    events' creation and record: ~32 µs a call on the card).  One event
    synchronize resolves them all, after the loop."""
    import bisect
    import itertools

    from torch.autograd import DeviceType

    from eigensolvers_tpu_torch import (TorchVector,
                                        inexactLanczosDiagonalization)
    from eigensolvers_tpu_torch.ops.operators import DenseOperator

    n = 3000
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    H = DenseOperator((q * np.linspace(1.0, 10.0, n)) @ q.T, device=dev)
    g, _ = np.linalg.qr(rng.standard_normal((n, 3)))
    opts = {"linearSystemArgs": {"linear_tol": 1e-4, "linearIter": 500,
                                 "preconditioner": "jacobi"}}
    vs = [TorchVector(g[:, i], opts, device=dev) for i in range(3)]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, _, st = inexactLanczosDiagonalization(H, vs, 0.5, 6, 3, 1e-9,
                                                 writeOut=False)
    calls, ops, phases, syncs = {}, [], [], 0
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        if e.device_type() == DeviceType.CPU:
            if e.linked_correlation_id():
                calls[e.correlation_id()] = s
            if e.name().startswith("es.lanczos."):
                phases.append((s, s + e.duration_ns(), e.name()))
            syncs += e.name() == "cudaEventSynchronize"
        elif e.device_type() == DeviceType.CUDA \
                and not e.is_user_annotation():
            ops.append((s + e.duration_ns(), e.correlation_id()))
    launched = sorted((calls[c], end) for end, c in ops if c in calls)
    at = [t for t, _ in launched]
    done = list(itertools.accumulate((end for _, end in launched), max))

    def ready(t):
        i = bisect.bisect_left(at, t) - 1
        return max(t, done[i]) if i >= 0 else t


    assert syncs == 1 and set(st["timers"]) >= {"solve", "orthogonalize",
                                                 "extend_subspace",
                                                 "diagonalize"}
    for name, t in st["timers"].items():
        mine = [(s, e) for s, e, p in phases if p == f"es.lanczos.{name}"]
        assert len(mine) == t["calls"]
        extent = sum(ready(e) - ready(s) for s, e in mine) / 1e9
        slack = max(0.02 * extent, 1e-3) + 1e-4 * t["calls"]
        assert abs(t["seconds"] - extent) <= slack, \
            (name, t["calls"], t["seconds"], extent)


def test_phase_timer_times_the_stream(dev):
    """A phase that only enqueues work reads the work's device time, not
    the host's enqueue: four f64 GEMMs of 4096 (~9 ms on an H100) against
    an event pair around the same launches."""
    import time

    from eigensolvers_tpu_torch.utils.profiling import PhaseTimer

    a = torch.randn(4096, 4096, dtype=torch.float64, device=dev)

    def gemms():
        for _ in range(4):
            a @ a

    gemms()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    gemms()
    end.record()
    end.synchronize()
    ref = start.elapsed_time(end) / 1e3
    timer = PhaseTimer("es.test", dev)
    host = time.perf_counter()
    with timer.phase("gemm"):
        gemms()
    host = time.perf_counter() - host
    got = timer.summary()["gemm"]
    assert got["calls"] == 1 and got["seconds"] > 5 * host
    assert abs(got["seconds"] - ref) <= 0.1 * ref, (got, ref, host)


# The sum-of-products contraction kernel (csrc/sop_contract.cu) against its
# plain version, each role: a fan-out from one input, in-place middle
# contractions, a fan-in summed into y.  (pre, N, post): both tiling modes
# (post >= 32 direct, post < 32 slab), the pre = 1 and post = 1 edges, N
# from 9 to 17 and 32 (whose 7 terms take two launches in f64).
SOP_SHAPES = [(9, 11, 13), (1, 17, 40), (37, 9, 1), (5, 16, 3), (3, 15, 33),
              (2, 32, 5)]


def _sop_inputs(pre, N, post, S, m, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    n = pre * N * post
    F = torch.randn((S, N, N), generator=g, device=dev, dtype=dtype)
    return F, [torch.randn((m, n), generator=g, device=dev, dtype=dtype)
               for _ in range(S + 1)]


@pytest.mark.parametrize("m", [1, 3, 5])
@pytest.mark.parametrize("role", ["fanout", "middle", "fanin"])
@pytest.mark.parametrize("pre,N,post", SOP_SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_sop_contract_matches_plain(dev, pre, N, post, role, m, dtype, tol):
    """Each role against the plain einsum in the same type; the bound is
    summation-order roundoff (N products a term, S terms a sum)."""
    from eigensolvers_tpu_torch.ops import operators as ops
    S = 7
    F, vecs = _sop_inputs(pre, N, post, S, m, dtype, dev)
    x, zs = vecs[0], vecs[1:]
    if role == "fanout":
        args = ([x] * S, [torch.empty_like(x) for _ in range(S)], False)
    elif role == "middle":
        args = (zs, zs, False)
    else:
        args = (zs, [x], True)
    ref_in = [t.clone() for t in args[0]]
    ref_out = [t.clone() for t in args[1]]
    if role == "middle":
        ref_out = ref_in
    ops.reset_launch_counts()
    ops.sop_contract(F, args[0], args[1], pre, post, sum_out=args[2],
                     beta=args[2])
    torch.cuda.synchronize()
    ops.sop_contract_plain(F, ref_in, ref_out, pre, post, sum_out=args[2],
                           beta=args[2])
    assert ops.launches["sop_contract"] == \
        -(-S // ops.sop_terms_per_launch(N, F.element_size()))
    for got, want in zip(args[1], ref_out):
        assert _relerr(got, want) <= tol


def test_sop_contract_refuses_what_it_does_not_take(dev):
    """The wrapper raises on what the kernel does not take, and a launch
    the library refuses raises through ``check``."""
    import ctypes
    from eigensolvers_tpu_torch.ops import kernels, operators as ops
    F, vecs = _sop_inputs(2, 33, 3, 1, 1, torch.float64, dev)
    with pytest.raises(ValueError, match="wide"):
        ops.sop_contract(F, vecs[:1], vecs[1:], 2, 3)
    F, vecs = _sop_inputs(2, 5, 3, 2, 1, torch.float64, dev)
    with pytest.raises(ValueError, match="lane stacks"):
        ops.sop_contract(F, [vecs[0], vecs[1].float()], vecs[:2], 2, 3)
    with pytest.raises(TypeError):
        ops.sop_contract(F.to(torch.int64), vecs[:2], vecs[1:], 2, 3)
    lib = kernels.sop_contract_library()
    addr = (ctypes.c_longlong * 1)(vecs[0].data_ptr())
    code = kernels.launch(lib.sop_contract_f64, F.device, F.data_ptr(), addr,
                          addr, 0, 5, 2, 3, 1, 30, 0, 0)
    with pytest.raises(RuntimeError, match="sop_contract launch failed"):
        kernels.check(lib, code, "sop_contract")


# The pair role (sop_pair) against its plain version: S = 34 terms on two
# modes of the (pre, Na, mid, Nb, post) view (two launches or more: a
# launch holds at most 32 terms, their factors within 48 KB in f64), as a sum
# into y, with and without beta, as slots, and both; pre = 1, adjacent
# modes (mid = 1), the last mode (post = 1), post 3, 17, 33 and 40 (a
# tile's 8 columns across units), N 9, 17 and 32.
PAIR_SHAPES = [(1, 17, 17, 17, 40), (9, 17, 1, 17, 1), (3, 9, 5, 9, 17),
               (2, 32, 1, 32, 3), (2, 9, 3, 17, 33)]
PAIR_ROLES = {"sum": (0, False), "beta": (0, True), "slots": (34, False),
              "both": (5, True)}


@pytest.mark.parametrize("m", [1, 3, 5])
@pytest.mark.parametrize("role", list(PAIR_ROLES))
@pytest.mark.parametrize("pre,Na,mid,Nb,post", PAIR_SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_sop_pair_matches_plain(dev, pre, Na, mid, Nb, post, role, m, dtype,
                                tol):
    """The kernel against the plain einsums in the same type; the bound is
    summation-order roundoff (Na + Nb products a term, 34 terms a sum; the
    kernel sums f32 in f64)."""
    from eigensolvers_tpu_torch.ops import operators as ops
    S, (nslot, beta) = 34, PAIR_ROLES[role]
    g = torch.Generator(device=dev).manual_seed(Na * Nb + post)
    n = pre * Na * mid * Nb * post
    A = torch.randn((S, Na, Na), generator=g, device=dev, dtype=dtype)
    B = torch.randn((S, Nb, Nb), generator=g, device=dev, dtype=dtype)
    x = torch.randn((m, n), generator=g, device=dev, dtype=dtype)
    y = None if nslot == S else torch.randn_like(x)
    outs = [torch.empty_like(x) for _ in range(nslot)]
    ref_outs = [torch.empty_like(x) for _ in range(nslot)]
    ref_y = None if y is None else y.clone()
    ops.reset_launch_counts()
    ops.sop_pair(A, B, x, outs, y, pre, mid, post, beta=beta)
    torch.cuda.synchronize()
    ops.sop_pair_plain(A, B, x, ref_outs, ref_y, pre, mid, post, beta=beta)
    assert ops.launches["sop_pair"] >= 2         # the table holds 32 terms
    assert ops.launches["sop_contract"] == 0
    for got, want in zip(outs + [y] * (y is not None),
                         ref_outs + [ref_y] * (y is not None)):
        assert _relerr(got, want) <= tol


def test_sop_pair_refuses_what_it_does_not_take(dev):
    """The wrapper raises on what the pair kernel does not take, and a
    launch the library refuses raises through ``check``."""
    import ctypes
    from eigensolvers_tpu_torch.ops import kernels, operators as ops
    f64 = dict(device=dev, dtype=torch.float64)
    A, B = torch.randn((2, 33, 33), **f64), torch.randn((2, 5, 5), **f64)
    x = torch.randn((1, 2 * 33 * 5), **f64)
    with pytest.raises(ValueError, match="wide"):
        ops.sop_pair(A, B, x, [], torch.empty_like(x), 1, 1, 2)
    A = torch.randn((2, 4, 4), **f64)
    x = torch.randn((1, 2 * 4 * 5), **f64)
    with pytest.raises(ValueError, match="lane stacks"):
        ops.sop_pair(A, B, x, [], x.float(), 1, 1, 2)
    with pytest.raises(ValueError, match="lane stack"):
        ops.sop_pair(A, B, x, [], torch.empty_like(x), 1, 1, 3)
    with pytest.raises(ValueError, match="slots"):
        ops.sop_pair(A, B, x, [torch.empty_like(x)], None, 1, 1, 2)
    with pytest.raises(TypeError):
        ops.sop_pair(A.to(torch.int64), B, x, [], torch.empty_like(x), 1, 1,
                     2)
    with pytest.raises(ValueError, match="one type"):
        ops.sop_pair(A, B.float(), x, [], torch.empty_like(x), 1, 1, 2)
    lib = kernels.sop_contract_library()
    addr = (ctypes.c_longlong * 1)(x.data_ptr())
    made = ctypes.c_int(-1)
    code = kernels.launch(lib.sop_pair_f64, A.device, A.data_ptr(),
                          B.data_ptr(), x.data_ptr(), addr, x.data_ptr(), 0,
                          0, 4, 5, 1, 1, 2, 1, 40, 0, ctypes.byref(made))
    assert made.value == 0
    with pytest.raises(RuntimeError, match="sop_pair launch failed"):
        kernels.check(lib, code, "sop_pair")


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_ch3cn_lane_apply_and_solve_run_the_sop_kernel(dev, dtype, tol):
    """A fused CH3CN cut on the card: its physical groups through the kernel
    (the pair role and the one-mode roles), the presummed 36-wide ones as
    GEMMs, equal to the plain route on the CPU; a short block solve counts
    the kernel's contractions and no row-by-row apply."""
    from eigensolvers_tpu_torch import TorchVector, inexactLanczosDiagonalization
    from eigensolvers_tpu_torch.models.molecules import ch3cn_operator
    from eigensolvers_tpu_torch.ops import operators as ops
    from eigensolvers_tpu_torch.utils import profiling
    kw = dict(N=6, nModesCut=6, fuse=36, dtype=dtype)
    op, spec, _ = ch3cn_operator(device=dev, **kw)
    cpu = ch3cn_operator(device="cpu", **kw)[0]
    assert {s[0] for s in op._steps} == {"gemm", "kernel"}
    X = torch.randn((3, op.shape[0]), dtype=op.dtype)
    assert _relerr(op.matvec_lanes(X.to(dev)).cpu(),
                   cpu.matvec_lanes(X)) <= tol
    if dtype == np.float32:
        return
    n = op.shape[0]
    G = torch.zeros((3, n), dtype=torch.float64)
    for row, k in enumerate((0, 6 ** 2, 6 ** 3)):
        G[row, k] = 1.0
    G += 1e-3 * torch.randn((3, n), dtype=torch.float64)
    G = torch.linalg.qr(G.T)[0].T.contiguous().to(dev)
    zpve = 0.5 * sum(spec.parameters[f"w{i + 1}"] for i in range(6))
    opts = {"linearSystemArgs": {"linearSolver": "minres", "linearIter": 200,
                                 "linear_tol": 1e-4,
                                 "preconditioner": "jacobi"}}
    ops.reset_launch_counts()
    before = profiling.snapshot()
    ev, _, _ = inexactLanczosDiagonalization(
        op, [TorchVector(g, opts) for g in G], zpve - 0.0023, 4, 2, 1e-8,
        writeOut=False)
    counts = profiling.delta(before)
    assert np.all(np.isfinite(np.asarray(ev)))
    assert ops.launches["sop_contract"] > 0
    assert ops.launches["sop_pair"] > 0
    assert counts["es.sop.kernel"]["calls"] > 0
    assert counts["es.sop.pair"]["calls"] > 0
    assert counts["es.sop.gemm"]["calls"] > 0
    assert "es.apply.rowwise" not in counts
