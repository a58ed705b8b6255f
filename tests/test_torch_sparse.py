"""The port's block-ELL operator and the plain versions of its kernels
(B1 ``bsr_spmv``, B2 ``bsr_spmv_split``, B3 ``bsr_spmm`` and its split
form) against the JAX package: its XLA paths ``_bsr_matvec_xla`` and
``_bsr_matmat_xla`` and its Pallas kernels run in interpret mode, as
tests/test_sparse.py runs them on the CPU.  The CUDA kernels themselves are
held against these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).  Also the banded operator against the JAX package's."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp
from eigensolvers_tpu import as_operator as jax_as_operator
from eigensolvers_tpu.ops.sparse import (BSROperator as JaxBSR,
                                         BandedOperator as JaxBanded,
                                         _bsr_matmat_xla,
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
    assert set(bsr.launches.values()) == {0}
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


# B3: nrb % 8 != 0, odd nbpr, and m across the kernel's chunk of 8
@pytest.mark.parametrize("m", [1, 3, 9])
@pytest.mark.parametrize("nrb,nbpr,B", [(5, 3, 32), (9, 5, 64), (3, 1, 64)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_b3_plain_matches_jax_xla(nrb, nbpr, B, m, dtype):
    dataT, idx, _ = _case(nrb, nbpr, B, dtype, seed=m)
    X = np.random.RandomState(m + 1).standard_normal((m, nrb * B)).astype(
        dtype)
    ref = np.asarray(_bsr_matmat_xla(jnp.asarray(dataT), jnp.asarray(idx),
                                     jnp.asarray(X)))
    Y = as_np(bsr.bsr_matmat(torch.as_tensor(dataT), torch.as_tensor(idx),
                             torch.as_tensor(X)))
    assert Y.dtype == dtype and Y.shape == (m, nrb * B)
    _close(Y, ref, dtype)


@pytest.mark.parametrize("m", [1, 3, 9])
def test_b3_split_plain_against_f64(m):
    """bf16x3 for a lane stack: element by element within 1e-5 of
    Σ|a·x| of the f64 product (each term's bf16x3 error is at most ~2^-16
    of |a·x| and the terms' errors do not align), and row k is B2's
    product of lane k up to f32 summation order (1e-6 of max |y|)."""
    dataT, idx, _ = _case(9, 5, 64, np.float32, seed=4)
    X = np.random.RandomState(m).standard_normal((m, 9 * 64)).astype(
        np.float32)
    hi, lo = _split(dataT)
    it, Xt = torch.as_tensor(idx), torch.as_tensor(X)
    Y = as_np(bsr.bsr_matmat_split(hi, lo, it, Xt))
    d64 = torch.as_tensor(dataT).double()
    y64 = as_np(bsr.bsr_matmat_plain(d64, it, Xt.double()))
    scale = as_np(bsr.bsr_matmat_plain(d64.abs(), it, Xt.double().abs()))
    assert Y.dtype == np.float32
    assert np.all(np.abs(Y - y64) <= 1e-5 * scale)
    for k in range(m):
        one = as_np(bsr.bsr_matvec_split(hi, lo, it, Xt[k]))
        assert np.abs(Y[k] - one).max() <= 1e-6 * np.abs(one).max()


@pytest.mark.parametrize("m", [1, 9])
@pytest.mark.parametrize("nrb,nbpr,B", [(5, 3, 32), (9, 5, 64), (4, 3, 128)])
def test_exact_split_oracle_tells_split_from_f32(nrb, nbpr, B, m):
    """The split plain versions summed in f64 (``acc``) give the exact
    bf16x3 product, the oracle the split kernels are held to
    (tests/test_torch_cuda.py, chip_smoke.py): at 2e-6 of max |y| for rows
    of up to 1152 terms, and by the signature t, the share of the split's
    own error d = y64 - exact that a result carries.  The f32 plain version
    meets the bound with |t| <= 0.1; a true-f32 product misses it, with
    |1 - t| <= 0.1.  The single-vector oracle is row k of the lane one."""
    dataT, idx, _ = _case(nrb, nbpr, B, np.float32, seed=m)
    X = torch.as_tensor(np.random.RandomState(m + 2).standard_normal(
        (m, nrb * B)).astype(np.float32))
    hi, lo = _split(dataT)
    it = torch.as_tensor(idx)
    exact = bsr.bsr_matmat_split_plain(hi, lo, it, X, acc=torch.float64)
    assert exact.dtype == torch.float64
    d = bsr.bsr_matmat_plain(torch.as_tensor(dataT).double(), it,
                             X.double()) - exact

    def rel(y):
        return float((y.double() - exact).abs().max() / exact.abs().max())

    def signature(y):
        return float(((y.double() - exact) * d).sum() / (d * d).sum())

    y = bsr.bsr_matmat_split_plain(hi, lo, it, X)
    y32 = bsr.bsr_matmat_plain(torch.as_tensor(dataT), it, X)
    assert rel(y) <= 2e-6 and abs(signature(y)) <= 0.1
    assert rel(y32) > 2e-6 and abs(1 - signature(y32)) <= 0.1
    for k in (0, m - 1):
        one = bsr.bsr_matvec_split_plain(hi, lo, it, X[k], acc=torch.float64)
        np.testing.assert_allclose(as_np(one), as_np(exact[k]), rtol=0,
                                   atol=1e-12 * float(exact.abs().max()))


def test_high_matmat_columns_are_high_matvecs():
    """At "high" the lane apply is the bf16x3 product, so column k of
    ``matmat`` is ``matvec`` of column k up to f32 summation order (the
    lane and single einsums group the same products differently): 1e-6 of
    max |y|.  A true-f32 product differs from it by 4e-6 to 6e-6."""
    rng = np.random.RandomState(0)
    n, B = 9 * 64 - 7, 64
    H = rng.standard_normal((n, n)).astype(np.float32)
    op = bsr.BSROperator.from_dense(H, block_size=B, precision="high")
    X = torch.as_tensor(rng.standard_normal((n, 3)).astype(np.float32))
    Y = as_np(op.matmat(X))
    for k in range(3):
        one = as_np(op.matvec(X[:, k]))
        assert np.abs(Y[:, k] - one).max() <= 1e-6 * np.abs(one).max()
    lanes = as_np(op.matvec_lanes(X.T.contiguous()))
    np.testing.assert_array_equal(lanes, Y.T)


@pytest.mark.parametrize("n,offsets", [(40, (-1, 0, 1)), (33, (-3, 0, 2, 5))])
def test_banded_operator_matches_jax(n, offsets):
    rng = np.random.RandomState(n)
    H = np.zeros((n, n))
    for d in offsets:
        H += np.diag(rng.standard_normal(n - abs(d)), d)
    jop = JaxBanded.from_dense(H)
    top = bsr.BandedOperator.from_dense(H)
    assert top.offsets == jop.offsets and top.bandwidth == jop.bandwidth
    np.testing.assert_array_equal(as_np(top.bands), np.asarray(jop.bands))
    x = rng.rand(n)
    X = rng.rand(3, n)
    np.testing.assert_allclose(as_np(top.matvec(torch.as_tensor(x))),
                               np.asarray(jop.matvec(x)), atol=1e-13)
    np.testing.assert_allclose(as_np(top.matvec_lanes(torch.as_tensor(X))),
                               X @ H.T, atol=1e-13)
    np.testing.assert_allclose(as_np(top.to_dense()),
                               np.asarray(jop.to_dense()), atol=0)
    np.testing.assert_allclose(as_np(top.diagonal()),
                               np.asarray(jop.diagonal()), atol=0)


def test_banded_operator_solves_like_jax():
    """A banded operator through both packages' MINRES (Jacobi), and an
    operator without a main diagonal."""
    from eigensolvers_tpu.ops import linear_solvers as jls
    from eigensolvers_tpu_torch.ops import linear_solvers as tls
    H = banded(150, bw=2, seed=5) + np.diag(np.linspace(1, 30, 150))
    jop = JaxBanded.from_dense(H)
    top = bsr.BandedOperator.from_dense(H)
    b = np.random.RandomState(6).rand(150)
    jr = jls.minres(jop, b, 12.5, rtol=1e-10, maxiter=3000, precond="jacobi")
    tr = tls.minres(top, torch.as_tensor(b), 12.5, rtol=1e-10, maxiter=3000,
                    precond="jacobi")
    np.testing.assert_allclose(as_np(tr.x), np.asarray(jr.x),
                               atol=1e-9 * np.abs(np.asarray(jr.x)).max())
    off = bsr.BandedOperator(np.ones((1, 5)), [1], 5)
    assert not np.any(as_np(off.diagonal()))


def test_lane_wrappers_refuse_devices_without_a_kernel():
    dataT, idx, _ = _case(2, 1, 32, np.float32)
    meta = torch.device("meta")
    args = [torch.as_tensor(a).to(meta) for a in
            (dataT, idx, np.zeros((2, 64), np.float32))]
    with pytest.raises(ValueError, match="no bsr_spmm kernel"):
        bsr.bsr_matmat(*args)
    hi, lo = _split(dataT)
    with pytest.raises(ValueError, match="no bsr_spmm_split kernel"):
        bsr.bsr_matmat_split(hi.to(meta), lo.to(meta), *args[1:])
