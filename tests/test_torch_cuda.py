"""The hand-written CUDA kernels (B1 and B2 single-vector SpMV, B3
multi-vector) against their plain PyTorch versions, on the card.  Marked ``cuda``: without a CUDA device every test here skips.
Run them on a machine with an NVIDIA Hopper GPU and the CUDA toolkit:

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


# Lane counts: one chunk at each MR (1, 2, 4, 8), a partial chunk (3) and
# m crossing the chunk of 8 (9, 17).
LANES = [1, 2, 3, 4, 8, 9, 17]


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


@pytest.mark.parametrize("m", LANES)
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
