"""The hand-written CUDA SpMV kernels against their plain PyTorch versions,
on the card.  Marked ``cuda``: without a CUDA device every test here skips.
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
    """B2 against its plain version (same bf16x3 products, summed in another
    order in f32: ≤1e-5) and against the f64 product of the f32 data
    (f32-grade, ≤1e-5)."""
    dataT, idx, x = _case(nrb, nbpr, B, torch.float32, dev, seed=1)
    hi = dataT.to(torch.bfloat16)
    lo = (dataT - hi.float()).to(torch.bfloat16)
    bsr.reset_launch_counts()
    y = bsr.bsr_matvec_split(hi, lo, idx, x)
    torch.cuda.synchronize()
    assert bsr.launches["bsr_spmv_split"] == 1
    assert _relerr(y, bsr.bsr_matvec_split_plain(hi, lo, idx, x)) <= 1e-5
    y64 = bsr.bsr_matvec_plain(dataT.double(), idx, x.double())
    assert _relerr(y, y64) <= 1e-5


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
