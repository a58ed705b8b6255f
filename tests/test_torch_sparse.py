"""The port's block-ELL operator and the plain versions of its two kernels
(B1 ``bsr_spmv``, B2 ``bsr_spmv_split``) against the JAX package: its XLA
path ``_bsr_matvec_xla`` and its Pallas kernels run in interpret mode, as
tests/test_sparse.py runs them on the CPU.  The CUDA kernels themselves are
held against these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp
from eigensolvers_tpu import as_operator as jax_as_operator
from eigensolvers_tpu.ops.sparse import (BSROperator as JaxBSR,
                                         _bsr_matvec_pallas,
                                         _bsr_matvec_pallas_split,
                                         _bsr_matvec_xla)

from eigensolvers_tpu_torch import as_operator
from eigensolvers_tpu_torch.ops import sparse as bsr
from test_torch_common import CPU, as_np, banded, torch_op


def _case(nrb, nbpr, B, dtype, seed=0):
    rng = np.random.RandomState(seed)
    dataT = rng.standard_normal((nrb, nbpr, B, B)).astype(dtype)
    idx = rng.randint(0, nrb, (nrb, nbpr)).astype(np.int32)
    x = rng.standard_normal(nrb * B).astype(dtype)
    return dataT, idx, x


def _plain_b1(dataT, idx, x):
    return as_np(bsr.bsr_matvec(torch.as_tensor(dataT), torch.as_tensor(idx),
                                torch.as_tensor(x)))


# Tolerances: f64 — summation order only (atol 1e-10 on O(10) entries);
# f32 — summation order in f32, 1e-5 relative to max |y|.
def _close(y, ref, dtype):
    if dtype == np.float64:
        np.testing.assert_allclose(y, ref, rtol=0, atol=1e-10)
    else:
        assert np.abs(y - ref).max() <= 1e-5 * np.abs(ref).max()


# nrb % 8 != 0 (the TPU kernel pads rows to 8), odd nbpr, B in {32, 64, 128}
SHAPES = [(4, 3, 128), (5, 3, 32), (9, 5, 64), (3, 1, 64), (6, 7, 32)]


@pytest.mark.parametrize("nrb,nbpr,B", SHAPES)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_b1_plain_matches_jax_xla(nrb, nbpr, B, dtype):
    dataT, idx, x = _case(nrb, nbpr, B, dtype)
    ref = np.asarray(_bsr_matvec_xla(jnp.asarray(dataT), jnp.asarray(idx),
                                     jnp.asarray(x)))
    y = _plain_b1(dataT, idx, x)
    assert y.dtype == dtype
    _close(y, ref, dtype)


@pytest.mark.parametrize("nrb,nbpr,B,dtype", [(5, 3, 32, np.float64),
                                              (9, 5, 64, np.float64),
                                              (4, 3, 128, np.float32)])
def test_b1_plain_matches_pallas_interpret(nrb, nbpr, B, dtype):
    dataT, idx, x = _case(nrb, nbpr, B, dtype, seed=1)
    ref = np.asarray(_bsr_matvec_pallas(jnp.asarray(dataT), jnp.asarray(idx),
                                        jnp.asarray(x), interpret=True))
    _close(_plain_b1(dataT, idx, x), ref, dtype)


def _split(dataT):
    hi = torch.as_tensor(dataT).to(torch.bfloat16)
    lo = (torch.as_tensor(dataT) - hi.float()).to(torch.bfloat16)
    return hi, lo


def _f64_oracle(dataT, idx, x):
    return _plain_b1(dataT.astype(np.float64), idx, x.astype(np.float64))


@pytest.mark.parametrize("nrb,nbpr,B", [(5, 3, 32), (4, 3, 128)])
def test_b2_plain_matches_pallas_interpret_and_f64(nrb, nbpr, B):
    """bf16x3 ("high"): the port's plain version and the Pallas split
    kernel agree to f32 summation order (1e-5 relative), and both stay
    within the f32-grade 1e-5 of the f64 product (tests/test_sparse.py:187)."""
    dataT, idx, x = _case(nrb, nbpr, B, np.float32, seed=3)
    hi, lo = _split(dataT)
    y = as_np(bsr.bsr_matvec_split(hi, lo, torch.as_tensor(idx),
                                   torch.as_tensor(x)))
    jdT = jnp.asarray(dataT)
    jhi = jdT.astype(jnp.bfloat16)
    jlo = (jdT - jhi.astype(jnp.float32)).astype(jnp.bfloat16)
    ref = np.asarray(_bsr_matvec_pallas_split(jhi, jlo, jnp.asarray(idx),
                                              jnp.asarray(x), interpret=True))
    y64 = _f64_oracle(dataT, idx, x)
    scale = np.abs(y64).max()
    assert y.dtype == np.float32
    assert np.abs(y - ref).max() <= 1e-5 * scale
    assert np.abs(y - y64).max() <= 1e-5 * scale
    assert np.abs(ref - y64).max() <= 1e-5 * scale


def test_b2_split_halves_match_jax_bitwise():
    """The port's hi/lo bf16 split of the blocks is the JAX package's, bit
    for bit (both round to nearest even)."""
    H = banded(256, bw=3, seed=2).astype(np.float32)
    jop = JaxBSR.from_dense(H, block_size=128, use_pallas=False,
                            precision="high")
    top = torch_op(jop)
    assert top.precision == "high"
    for mine, theirs in ((top.dataT_hi, jop.dataT_hi),
                         (top.dataT_lo, jop.dataT_lo)):
        np.testing.assert_array_equal(
            mine.view(torch.int16).numpy(),
            np.asarray(theirs).view(np.int16))


@pytest.mark.parametrize("n,B,build", [(200, 64, "dense"), (150, 64, "scipy"),
                                       (256, 32, "dense")])
def test_operator_parity_via_convert(n, B, build):
    """from_dense/from_scipy in the port build the JAX package's arrays;
    the converted operator carries them as stored; matvec, matmat,
    diagonal and to_dense agree, with n not a multiple of B."""
    H = banded(n, bw=5, seed=7)
    if build == "dense":
        jop = JaxBSR.from_dense(H, block_size=B, use_pallas=False)
        mine = bsr.BSROperator.from_dense(H, block_size=B)
    else:
        jop = JaxBSR.from_scipy(sp.csr_matrix(H), block_size=B,
                                use_pallas=False)
        mine = bsr.BSROperator.from_scipy(sp.csr_matrix(H), block_size=B)
    conv = torch_op(jop)
    np.testing.assert_array_equal(as_np(mine.dataT), np.asarray(jop.dataT))
    np.testing.assert_array_equal(as_np(conv.dataT), np.asarray(jop.dataT))
    np.testing.assert_array_equal(as_np(conv.idx), np.asarray(jop.idx))
    rng = np.random.RandomState(8)
    x = rng.rand(n)
    X = rng.rand(n, 4)
    for op in (mine, conv):
        np.testing.assert_allclose(as_np(op.matvec(torch.as_tensor(x))),
                                   np.asarray(jop.matvec(x)), atol=1e-11)
        np.testing.assert_allclose(as_np(op.matmat(torch.as_tensor(X))),
                                   np.asarray(jop.matmat(X)), atol=1e-11)
        np.testing.assert_allclose(as_np(op.diagonal()),
                                   np.asarray(jop.diagonal()), atol=0)
        np.testing.assert_allclose(as_np(op.to_dense()), H, atol=1e-13)
        assert op.shape == (n, n) and op.n_padded == jop.n_padded


def test_as_operator_accepts_scipy_sparse():
    H = sp.csr_matrix(banded(100, bw=2, seed=9))
    op = as_operator(H)
    assert isinstance(op, bsr.BSROperator)
    x = np.random.RandomState(0).rand(100)
    np.testing.assert_allclose(as_np(op.matvec(torch.as_tensor(x))),
                               np.asarray(jax_as_operator(H).matvec(x)),
                               atol=1e-11)


@pytest.mark.parametrize("prec", ["default", "high", "highest"])
def test_cpu_matvec_takes_plain_path_and_launches_nothing(prec):
    """On CPU tensors every precision runs the plain versions: the kernel
    launch counters stay at 0.  "high" keeps the hi/lo buffers, which move
    with the module and appear in its state_dict."""
    H = banded(256, bw=3, seed=2).astype(np.float32)
    op = bsr.BSROperator.from_dense(H, block_size=128, precision=prec)
    bsr.reset_launch_counts()
    x = np.random.RandomState(0).rand(256).astype(np.float32)
    y = as_np(op.matvec(torch.as_tensor(x)))
    assert bsr.launches == {"bsr_spmv": 0, "bsr_spmv_split": 0}
    assert np.abs(y - H @ x).max() <= 1e-5 * np.abs(H @ x).max()
    keys = set(op.state_dict())
    assert {"dataT", "idx"} <= keys
    assert ({"dataT_hi", "dataT_lo"} <= keys) == (prec == "high")
    assert op.to(CPU).dataT.device == CPU


def test_wrappers_refuse_devices_without_a_kernel():
    dataT, idx, x = _case(2, 1, 32, np.float32)
    meta = torch.device("meta")
    args = [torch.as_tensor(a).to(meta) for a in (dataT, idx, x)]
    with pytest.raises(ValueError, match="no bsr_spmv kernel"):
        bsr.bsr_matvec(*args)
    hi, lo = _split(dataT)
    with pytest.raises(ValueError, match="no bsr_spmv_split kernel"):
        bsr.bsr_matvec_split(hi.to(meta), lo.to(meta), *args[1:])


def test_constructor_validates_layout():
    dataT, idx, _ = _case(3, 2, 32, np.float64)
    with pytest.raises(ValueError, match="block-column"):
        bsr.BSROperator(dataT, idx + 3, 96)
    with pytest.raises(ValueError, match="idx"):
        bsr.BSROperator(dataT, idx[:, :1], 96)
    with pytest.raises(ValueError, match="does not fit"):
        bsr.BSROperator(dataT, idx, 97)
