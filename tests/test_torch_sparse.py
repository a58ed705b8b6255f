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
        mine = bsr.BSROperator.from_dense(H, block_size=B, device=CPU)
    else:
        jop = JaxBSR.from_scipy(sp.csr_matrix(H), block_size=B,
                                use_pallas=False)
        mine = bsr.BSROperator.from_scipy(sp.csr_matrix(H), block_size=B,
                                          device=CPU)
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
    op = as_operator(H, device=CPU)
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
    op = bsr.BSROperator.from_dense(H, block_size=128, precision=prec,
                                    device=CPU)
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
        bsr.BSROperator(dataT, idx + 3, 96, device=CPU)
    with pytest.raises(ValueError, match="idx"):
        bsr.BSROperator(dataT, idx[:, :1], 96, device=CPU)
    with pytest.raises(ValueError, match="does not fit"):
        bsr.BSROperator(dataT, idx, 97, device=CPU)


@pytest.mark.parametrize("n,B", [(64, 16), (90, 32)])
def test_same_constructor_arguments_build_the_same_operator(n, B):
    """F5: ``BSROperator(data, idx, n)`` takes the blocks in natural
    orientation in both packages (the port once took the transposed
    layout here and built another operator, max |dy| 5.43 at n = 64), and
    both take ``use_pallas``.  f64, 1e-12; ``data``, ``dataT`` and ``nnz``
    agree, and ``from_transposed`` of the stored layout is the same
    operator."""
    H = np.random.RandomState(n).standard_normal((n, n))
    H = H + H.T
    data = np.asarray(JaxBSR.from_dense(H, block_size=B).data)
    idx = np.asarray(JaxBSR.from_dense(H, block_size=B).idx)
    jop = JaxBSR(data, idx, n, use_pallas=False)
    mine = bsr.BSROperator(data, idx, n, use_pallas=False, device=CPU)
    again = bsr.BSROperator.from_transposed(mine.dataT, mine.idx, n)
    assert again.dataT.data_ptr() == mine.dataT.data_ptr()
    x = np.random.RandomState(1).standard_normal(n)
    X = np.random.RandomState(2).standard_normal((n, 3))
    for op in (mine, again):
        np.testing.assert_allclose(as_np(op.matvec(torch.as_tensor(x))),
                                   np.asarray(jop.matvec(x)), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(as_np(op.matmat(torch.as_tensor(X))),
                                   np.asarray(jop.matmat(X)), rtol=0,
                                   atol=1e-12)
    np.testing.assert_allclose(as_np(mine.matvec(torch.as_tensor(x))), H @ x,
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(as_np(mine.data), np.asarray(jop.data))
    np.testing.assert_array_equal(as_np(mine.dataT), np.asarray(jop.dataT))
    assert mine.nnz == jop.nnz == data.size
    for build in (bsr.BSROperator.from_dense, bsr.BSROperator.from_scipy):
        op = build(sp.csr_matrix(H) if build is bsr.BSROperator.from_scipy
                   else H, block_size=B, use_pallas=True, device=CPU)
        np.testing.assert_allclose(as_np(op.matvec(torch.as_tensor(x))),
                                   H @ x, rtol=0, atol=1e-12)


# B3: nrb % 8 != 0, odd nbpr, and m across the kernel's routes (CUDA-core
# tiles up to 16 lanes, tensor-core tiles of 16 to 64 from 17) and the 48
# and 64 lanes of the FEAST and slicing stacks
@pytest.mark.parametrize("m", [1, 3, 9, 16, 32, 33, 48, 64])
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
    op = bsr.BSROperator.from_dense(H, block_size=B, precision="high",
                                    device=CPU)
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
    top = bsr.BandedOperator.from_dense(H, device=CPU)
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
    top = bsr.BandedOperator.from_dense(H, device=CPU)
    b = np.random.RandomState(6).rand(150)
    jr = jls.minres(jop, b, 12.5, rtol=1e-10, maxiter=3000, precond="jacobi")
    tr = tls.minres(top, torch.as_tensor(b), 12.5, rtol=1e-10, maxiter=3000,
                    precond="jacobi")
    np.testing.assert_allclose(as_np(tr.x), np.asarray(jr.x),
                               atol=1e-9 * np.abs(np.asarray(jr.x)).max())
    off = bsr.BandedOperator(np.ones((1, 5)), [1], 5, device=CPU)
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


def _count_lane_calls(monkeypatch):
    """Record the lane count of every B3 call (f32/f64 and split forms)
    the operator makes; the plain versions run as before."""
    calls = []
    for name in ("bsr_matmat", "bsr_matmat_split"):
        fn = getattr(bsr, name)

        def spy(*args, fn=fn, name=name):
            calls.append((name, args[-1].shape[0], args[-1].dtype))
            return fn(*args)
        monkeypatch.setattr(bsr, name, spy)
    for name in ("bsr_matvec", "bsr_matvec_split"):
        monkeypatch.setattr(bsr, name, lambda *a: pytest.fail("single SpMV"))
    return calls


# Tolerances: max |y - to_dense() @ x| relative to max |to_dense() @ x|:
# f64 1e-12, f32 1e-6 (summation order in the working type).
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-6)])
@pytest.mark.parametrize("precision", ["highest", "high"])
def test_complex_vectors_on_real_blocks_take_real_lanes(dtype, tol, precision,
                                                        monkeypatch):
    """A complex x or lane stack (m, n) on real blocks: its real and
    imaginary parts as 2m real lanes of ONE B3 call, recombined; the dense
    product within the tolerance ("high" f32 data: the bf16x3 split form,
    held at 2e-5 like B3's split lanes against f64)."""
    rng = np.random.RandomState(3)
    n, B = 5 * 32 - 9, 32
    H = rng.standard_normal((n, n)).astype(dtype)
    op = bsr.BSROperator.from_dense(H, block_size=B, precision=precision,
                                    device=CPU)
    cdt = torch.complex128 if dtype == np.float64 else torch.complex64
    x = torch.as_tensor(rng.standard_normal(n) + 1j * rng.standard_normal(n),
                        dtype=cdt)
    X = torch.as_tensor(rng.standard_normal((3, n))
                        + 1j * rng.standard_normal((3, n)), dtype=cdt)
    dense = as_np(op.to_dense()).astype(np.complex128)
    if precision == "high" and dtype == np.float32:
        tol = 2e-5
    calls = _count_lane_calls(monkeypatch)
    y = op.matvec(x)
    Y = op.matvec_lanes(X)
    Yc = op.matmat(X.T)
    assert y.dtype == Y.dtype == cdt
    split = precision == "high" and dtype == np.float32
    name = "bsr_matmat_split" if split else "bsr_matmat"
    rdt = torch.float64 if dtype == np.float64 else torch.float32
    assert calls == [(name, 2, rdt), (name, 6, rdt), (name, 6, rdt)]
    for got, ref in ((y, dense @ as_np(x)), (Y, as_np(X) @ dense.T),
                     (Yc.T, as_np(X) @ dense.T)):
        assert np.abs(as_np(got) - ref).max() <= tol * np.abs(ref).max()


def test_complex128_vector_on_f32_blocks_applies_in_f64(monkeypatch):
    """A complex128 x on f32 blocks: f64 lanes of the f32 data (the JAX
    package's promotion), complex128 out."""
    rng = np.random.RandomState(4)
    H = rng.standard_normal((64, 64)).astype(np.float32)
    op = bsr.BSROperator.from_dense(H, block_size=32, device=CPU)
    x = torch.as_tensor(rng.standard_normal(64) + 1j * rng.standard_normal(64))
    calls = _count_lane_calls(monkeypatch)
    y = op.matvec(x)
    assert calls == [("bsr_matmat", 2, torch.float64)]
    ref = H.astype(np.float64) @ as_np(x)
    assert y.dtype == torch.complex128
    assert np.abs(as_np(y) - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("xkind", ["real", "complex"])
def test_complex_blocks_apply_as_two_real_block_sets(xkind, monkeypatch):
    """Complex blocks (the JAX package takes them, through XLA) apply as
    their real and imaginary block sets, one B3 call each, and match the
    JAX operator and the dense product to 1e-12."""
    rng = np.random.RandomState(5)
    n = 3 * 32 - 4
    H = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    jop = JaxBSR.from_dense(H, block_size=32, use_pallas=False)
    op = torch_op(jop)
    assert op.dtype == torch.complex128
    X = rng.standard_normal((2, n))
    if xkind == "complex":
        X = X + 1j * rng.standard_normal((2, n))
    calls = _count_lane_calls(monkeypatch)
    Y = op.matvec_lanes(torch.as_tensor(X))
    lanes = 4 if xkind == "complex" else 2
    assert calls == [("bsr_matmat", lanes, torch.float64)] * 2
    ref = X @ H.T
    assert np.abs(as_np(Y) - ref).max() <= 1e-12 * np.abs(ref).max()
    y = op.matvec(torch.as_tensor(X[0]))
    np.testing.assert_allclose(as_np(y), np.asarray(jop.matvec(X[0])),
                               rtol=0, atol=1e-12 * np.abs(ref).max())
    np.testing.assert_allclose(as_np(op.diagonal()), np.diagonal(H), atol=0)


# ----------------------------------------------------------------------------
# Row blocks: nrb block rows of an operator with ncb block columns, the
# rectangular form that a rank's rows of a row-sharded operator take
# ----------------------------------------------------------------------------
def _rect_case(nrb, ncb, nbpr, B, m, seed=3):
    rng = np.random.RandomState(seed)
    dataT = rng.standard_normal((nrb, nbpr, B, B))
    idx = np.stack([np.sort(rng.choice(ncb, nbpr, replace=False))
                    for _ in range(nrb)]).astype(np.int32)
    X = rng.standard_normal((m, ncb * B))
    D = np.zeros((nrb * B, ncb * B))
    for r in range(nrb):
        for t in range(nbpr):
            c = idx[r, t]
            D[r * B:(r + 1) * B, c * B:(c + 1) * B] += dataT[r, t].T
    return dataT, idx, X, D


@pytest.mark.parametrize("nrb,ncb,nbpr,B", [(2, 8, 3, 16), (3, 5, 2, 32),
                                            (5, 5, 3, 8)])
def test_rectangular_plain_versions_match_the_dense_product(nrb, ncb, nbpr,
                                                            B):
    """x of ncb*B elements -> nrb*B rows: B1, B3 and both split forms'
    plain versions against the dense rows (f64, 1e-12; the split forms to
    their bf16x3 error, 1e-5)."""
    dataT, idx, X, D = _rect_case(nrb, ncb, nbpr, B, 3)
    dT, it, Xt = (torch.as_tensor(a) for a in (dataT, idx, X))
    ref = X @ D.T
    np.testing.assert_allclose(as_np(bsr.bsr_matvec_plain(dT, it, Xt[0])),
                               ref[0], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(as_np(bsr.bsr_matmat_plain(dT, it, Xt)), ref,
                               rtol=1e-12, atol=1e-12)
    d32 = dT.float()
    hi = d32.to(torch.bfloat16)
    lo = (d32 - hi.float()).to(torch.bfloat16)
    for got in (bsr.bsr_matvec_split_plain(hi, lo, it, Xt[0].float())[None],
                bsr.bsr_matmat_split_plain(hi, lo, it, Xt.float())):
        k = got.shape[0]
        assert np.abs(as_np(got) - ref[:k]).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_row_blocks_of_an_operator_give_its_rows(precision):
    """The block rows [r0, r1) of a square BSROperator, as a row block
    (``ncb`` = nrb), give exactly the rows [r0*B, r1*B) of the whole
    operator's product, single vector and lane stack alike."""
    nrb, nbpr, B = 8, 3, 16
    dataT, idx, X, D = _rect_case(nrb, nrb, nbpr, B, 4)
    dtype = torch.float32 if precision == "high" else torch.float64
    whole = bsr.BSROperator.from_transposed(torch.as_tensor(dataT).to(dtype),
                                            idx, nrb * B, precision=precision,
                                            device=CPU)
    Xt = torch.as_tensor(X).to(dtype)
    Y = whole.matvec_lanes(Xt)
    y = whole.matvec(Xt[0])
    for r0, r1 in ((0, 2), (2, 5), (5, 8)):
        blk = bsr.BSROperator.from_transposed(
            whole.dataT[r0:r1], whole.idx[r0:r1], (r1 - r0) * B,
            precision=precision, ncb=nrb)
        assert blk.shape == ((r1 - r0) * B, nrb * B) and not blk.square
        rows = slice(r0 * B, r1 * B)
        assert torch.equal(blk.matvec_lanes(Xt), Y[:, rows])
        assert torch.equal(blk.matvec(Xt[0]), y[rows])
    np.testing.assert_allclose(as_np(Y).astype(np.float64), X @ D.T,
                               rtol=1e-5, atol=1e-5 * np.abs(X @ D.T).max())


def test_row_blocks_check_their_column_ids_once_when_built():
    dataT, idx, X, D = _rect_case(2, 6, 2, 8, 1)
    bsr.BSROperator.from_transposed(dataT, idx, 16, ncb=6, device=CPU)
    with pytest.raises(ValueError, match=r"\[0, 4\)"):
        bsr.BSROperator.from_transposed(dataT, idx, 16, ncb=4, device=CPU)
    blk = bsr.BSROperator.from_transposed(dataT, idx, 16, ncb=6, device=CPU)
    with pytest.raises(ValueError, match="bad lane stack"):
        blk.matvec_lanes(torch.as_tensor(X[:, :16]))
    with pytest.raises(ValueError, match="no diagonal"):
        blk.diagonal()


@pytest.mark.parametrize("nrb,ncb,nbpr,B", [(5, 5, 3, 8), (2, 8, 3, 16),
                                            (3, 5, 2, 32)])
@pytest.mark.parametrize("lanes", [0, 3])
def test_library_yardstick_is_the_same_product(nrb, ncb, nbpr, B, lanes):
    """``tools/yardstick.py::sparse_bsr``, the one library call the kernels
    are timed beside (``chip_smoke.py``, ``tools/bench_spmm.py``): ``A @
    x`` of the stored blocks gives the dense rows for one vector (``lanes``
    0) and a stack of columns, square and as a row block with the whole x
    (f64, 1e-12), and the JAX package's XLA product of a square operator."""
    from eigensolvers_tpu_torch.tools.yardstick import sparse_bsr
    dataT, idx, X, D = _rect_case(nrb, ncb, nbpr, B, 5)
    A = sparse_bsr(torch.as_tensor(dataT), torch.as_tensor(idx), ncb * B)
    x = torch.as_tensor(X[0] if lanes == 0 else X[:lanes].T.copy())
    ref = D @ as_np(x)
    np.testing.assert_allclose(as_np(A @ x), ref, rtol=1e-12, atol=1e-12)
    if nrb == ncb and lanes == 0:
        jax_y = np.asarray(_bsr_matvec_xla(jnp.asarray(dataT),
                                           jnp.asarray(idx),
                                           jnp.asarray(X[0])))
        np.testing.assert_allclose(as_np(A @ x), jax_y, rtol=1e-12,
                                   atol=1e-12)
