"""Block-sparse and banded operators; the block-sparse one applies through
hand-written CUDA kernels.

:class:`BSROperator` — block-ELL layout (fixed number of BxB blocks per
block-row, zero-padded): ``data (nrb, nbpr, B, B)``, ``idx (nrb, nbpr)``.
The matvec gathers whole B-blocks of x, so every flop is a dense (B, B)
block product.  The constructor takes the blocks in natural orientation, as
the JAX package's does, and stores them per-block TRANSPOSED once, the
layout every apply path consumes (``dataT[r, t, j, i] = H[r*B + i,
idx[r, t]*B + j]``), so no apply re-transposes the whole array;
:meth:`BSROperator.from_transposed` takes that layout as it is.

Execution paths, chosen by the device of the tensors alone:

* single vector (:meth:`BSROperator.matvec`) on a CUDA tensor: B1
  (counted as ``bsr_spmv``), the port of the JAX package's Pallas kernel
  ``_bsr_matvec_pallas``, at "highest" or "default" for f32 or f64: the
  kernel of B3 (``csrc/bsr_spmm.cu``) launched with one vector; at
  ``precision="high"`` on f32 data B2, the
  port of ``_bsr_matvec_pallas_split``: the bf16x3 tensor-core kernel
  ``csrc/bsr_spmm_split.cu`` launched with one vector (counted as
  ``bsr_spmv_split``);
* a lane stack of m vectors (:meth:`BSROperator.matvec_lanes`, under
  ``matmat`` and every batched solve) on a CUDA tensor: the ``bsr_spmm``
  kernel (``csrc/bsr_spmm.cu``, B3), which replaces the JAX package's XLA
  ``_bsr_matmat_xla``; at "high" on f32 data its bf16x3 form
  ``bsr_spmm_split`` (``csrc/bsr_spmm_split.cu``), so a lane sees the
  same operator as a single vector;
* complex vectors: a complex x or lane stack (m, n) is applied as its real
  and imaginary parts stacked as 2m real lanes, one B3 launch on the real
  blocks, and recombined; the blocks are never promoted to complex.
  Complex blocks (which the JAX package also takes) are kept as their real
  and imaginary block sets, one B3 launch each;
* CPU tensor: the plain PyTorch versions (gather + einsum), which are also
  the references the kernels are tested against.  Complex data takes the
  same real-lane route there.

Every path takes the rectangular form too: a row block of an operator
(``ncb`` block columns, more than its nrb block rows) applies to the whole
x of ncb*B elements and gives its own nrb*B rows, computed exactly as the
same rows of the square launch are (the kernels' grids run over block
rows).  The row-sharded operators of :mod:`eigensolvers_tpu_torch.parallel`
apply their ranks' block rows so, to the gathered x.

A CUDA tensor reaches its kernel or raises; nothing falls back to the plain
version.

:class:`BandedOperator` (diagonals at fixed offsets) is plain PyTorch on
every device: static shifted slices, no gather (the JAX package leaves it
to XLA too).
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels import bsr_spmm_library, bsr_spmm_split_library, check, launch
from .operators import AbstractOperator, as_tensor, resolve_precision

#: Kernel launches since the last :func:`reset_launch_counts`, by kernel.
#: Each CUDA wrapper adds one where it launches its kernel, and nowhere else.
launches = {"bsr_spmv": 0, "bsr_spmv_split": 0, "bsr_spmm": 0,
            "bsr_spmm_split": 0}

# The largest block the kernels are checked at (tests/test_torch_cuda.py,
# chip_smoke.py).  Both kernel files cover B > 128 as CTAs of 128 output
# rows on the grid's y axis, so no CTA limit sets it; a larger B is taken
# only once it is tested.
_MAX_BLOCK = 1024
# B3 and its split form run more than 64 vectors as chunks of (at most) 64,
# the grid's x axis counting block rows times chunks.
_LANE_CHUNK = 64
_MAX_GRID_X = 2 ** 31 - 1


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


class BSROperator(AbstractOperator):
    """Block-ELL sparse operator (see module docstring).

    ``data (nrb, nbpr, B, B)`` holds the blocks in natural orientation
    (``data[r, t] = H[r*B:(r+1)*B, idx[r, t]*B:(idx[r, t]+1)*B]``), as the
    JAX package's constructor takes them; :meth:`from_transposed` takes the
    stored per-block transposed ``dataT`` without a copy, and
    :meth:`from_dense` / :meth:`from_scipy` build from a matrix.
    ``precision="high"`` on f32 data precomputes the bf16 hi/lo split of the
    blocks (same bytes as f32) for the split kernel; "highest" and "default"
    apply in the data's own precision.  ``use_pallas`` is accepted for the
    JAX package's signature and ignored: the device of the tensors alone
    picks the path (a CUDA tensor always runs its kernel), and there is no
    Pallas here.

    ``ncb`` (default: nrb, square) makes a row block: nrb block rows of an
    operator with ncb block columns, ``n`` rows, applied to x of ncb*B
    elements (``shape`` is (n, ncb*B)); every block-column id is checked
    below ncb here, once."""

    def __init__(self, data, idx, n: int, use_pallas=None,
                 precision="highest", device=None, ncb=None):
        super().__init__()
        data = as_tensor(data, device)
        if data.ndim != 4 or data.shape[2] != data.shape[3]:
            raise ValueError(f"data must be (nrb, nbpr, B, B), got "
                             f"{tuple(data.shape)}")
        self._store(data.transpose(2, 3), idx, n, precision, ncb)

    @classmethod
    def from_transposed(cls, dataT, idx, n: int, precision="highest",
                        device=None, ncb=None) -> "BSROperator":
        """The operator of the per-block transposed blocks ``dataT`` (the
        stored layout, ``BSROperator.dataT`` of either package), kept as
        they are: a contiguous tensor on ``device`` is not copied."""
        self = cls.__new__(cls)
        AbstractOperator.__init__(self)
        self._store(as_tensor(dataT, device), idx, n, precision, ncb)
        return self

    def _store(self, dataT, idx, n, precision, ncb=None):
        idx = as_tensor(idx, dataT.device, torch.int32)
        if dataT.ndim != 4 or dataT.shape[2] != dataT.shape[3]:
            raise ValueError(f"dataT must be (nrb, nbpr, B, B), got "
                             f"{tuple(dataT.shape)}")
        nrb, nbpr, B, _ = dataT.shape
        if tuple(idx.shape) != (nrb, nbpr):
            raise ValueError(f"idx must be {(nrb, nbpr)}, got "
                             f"{tuple(idx.shape)}")
        if nrb < 1 or nbpr < 1:
            raise ValueError(f"empty operator {tuple(dataT.shape)}")
        self.ncb = nrb if ncb is None else int(ncb)
        if not 0 <= int(idx.min()) <= int(idx.max()) < self.ncb:
            raise ValueError(f"block-column ids must lie in [0, {self.ncb})")
        if not (nrb - 1) * B < int(n) <= nrb * B:
            raise ValueError(f"n={n} does not fit {nrb} block rows of {B}")
        self.register_buffer("dataT", dataT.contiguous())
        self.register_buffer("idx", idx.contiguous())
        self.n = int(n)                    # logical (unpadded) dimension
        self.precision = resolve_precision(precision)
        if self.precision == "high" and dataT.dtype == torch.float32:
            hi = self.dataT.to(torch.bfloat16)
            self.register_buffer("dataT_hi", hi)
            self.register_buffer(
                "dataT_lo", (self.dataT - hi.float()).to(torch.bfloat16))
        else:
            self.register_buffer("dataT_hi", None)
            self.register_buffer("dataT_lo", None)
        if dataT.is_complex():
            # the kernels take real blocks: keep both real block sets
            self.register_buffer("dataT_re", self.dataT.real.contiguous())
            self.register_buffer("dataT_im", self.dataT.imag.contiguous())
        else:
            self.register_buffer("dataT_re", None)
            self.register_buffer("dataT_im", None)

    # -- properties ---------------------------------------------------------
    @property
    def block_size(self) -> int:
        return int(self.dataT.shape[2])

    @property
    def n_padded(self) -> int:
        return int(self.dataT.shape[0] * self.block_size)

    @property
    def square(self) -> bool:
        return self.ncb == self.dataT.shape[0]

    @property
    def _cols(self) -> dict:
        """The wrappers' ``ncb`` argument: none for a square operator."""
        return {} if self.square else {"ncb": self.ncb}

    @property
    def n_cols(self) -> int:
        """Length of the x it applies to: n when square, else ncb*B."""
        return self.n if self.square else self.ncb * self.block_size

    @property
    def shape(self):
        return (self.n, self.n_cols)

    @property
    def dtype(self):
        return self.dataT.dtype

    @property
    def data(self):
        """The blocks in natural orientation (a transposed view of
        ``dataT``)."""
        return self.dataT.transpose(2, 3)

    @property
    def nnz(self) -> int:
        """Stored element count (explicit zeros of padding blocks
        included)."""
        return int(self.dataT.numel())

    # -- construction -------------------------------------------------------
    @classmethod
    def from_dense(cls, H, block_size: int = 128, drop_tol: float = 0.0,
                   use_pallas=None, precision="highest",
                   device=None) -> "BSROperator":
        H = np.asarray(H)
        n = H.shape[0]
        B = block_size
        nrb = -(-n // B)
        Hp = np.zeros((nrb * B, nrb * B), H.dtype)
        Hp[:n, :n] = H
        blocks = Hp.reshape(nrb, B, nrb, B).transpose(0, 2, 1, 3)
        norms = np.abs(blocks).max(axis=(2, 3))
        keep = norms > drop_tol
        nbpr = max(1, int(keep.sum(axis=1).max()))
        data = np.zeros((nrb, nbpr, B, B), H.dtype)
        idx = np.zeros((nrb, nbpr), np.int32)
        for r in range(nrb):
            cols = np.nonzero(keep[r])[0]
            for t, c in enumerate(cols[:nbpr]):
                data[r, t] = blocks[r, c]
                idx[r, t] = c
        return cls(data, idx, n, precision=precision, device=device)

    @classmethod
    def from_scipy(cls, H, block_size: int = 128, use_pallas=None,
                   precision="highest", device=None) -> "BSROperator":
        """Build from a scipy.sparse matrix without densifying the whole
        matrix at once (block-row streaming)."""
        import scipy.sparse as sp
        H = sp.csr_matrix(H)
        n = H.shape[0]
        B = block_size
        nrb = -(-n // B)
        rows, cols = H.nonzero()
        block_ids = {}
        for r, c in zip(rows // B, cols // B):
            block_ids.setdefault(int(r), set()).add(int(c))
        nbpr = max(1, max((len(v) for v in block_ids.values()), default=1))
        dataT = np.zeros((nrb, nbpr, B, B), H.dtype)
        idx = np.zeros((nrb, nbpr), np.int32)
        for r in range(nrb):
            rl = r * B
            rh = min((r + 1) * B, n)
            strip = H[rl:rh]
            for t, c in enumerate(sorted(block_ids.get(r, []))):
                cl = c * B
                ch = min((c + 1) * B, n)
                dataT[r, t, :ch - cl, :rh - rl] = strip[:, cl:ch].toarray().T
                idx[r, t] = c
        return cls.from_transposed(dataT, idx, n, precision=precision,
                                   device=device)

    # -- application --------------------------------------------------------
    def _pad(self, x: torch.Tensor, dtype) -> torch.Tensor:
        """Zero-pad the last axis from n_cols to ncb*B, contiguous."""
        xp = x.to(dtype)
        ncols = self.ncb * self.block_size
        if ncols != self.n_cols:
            xp = torch.nn.functional.pad(xp, (0, ncols - self.n_cols))
        return xp.contiguous()

    def matvec(self, x):
        """y = A x; a row block maps x (n_cols,) to its n rows, flat."""
        flat = x.reshape(-1)
        shape = x.shape if self.square else (self.n,)
        if flat.is_complex() or self.dtype.is_complex:
            return self.matvec_lanes(flat[None])[0].reshape(shape)
        dtype = torch.promote_types(self.dtype, flat.dtype)
        xp = self._pad(flat, dtype)
        if self.dataT_hi is not None and dtype == torch.float32:
            yp = bsr_matvec_split(self.dataT_hi, self.dataT_lo, self.idx, xp,
                                  **self._cols)
        else:
            yp = bsr_matvec(self.dataT.to(dtype), self.idx, xp, **self._cols)
        return yp[:self.n].reshape(shape)

    def matvec_lanes(self, X):
        """Apply to each row of the lane stack X (m, n) -> (m, n) in one
        multi-vector product: the block data is read once for all m rows.
        At "high" on f32 data this is the bf16x3 product, like ``matvec``.
        Complex data goes through real lanes (see the module docstring).
        A row block maps X (m, n_cols) to its (m, n) rows."""
        if X.ndim != 2 or X.shape[1] != self.n_cols:
            raise ValueError(f"bad lane stack shape {tuple(X.shape)}")
        if not (X.is_complex() or self.dtype.is_complex):
            return self._real_lanes(self.dataT, X)
        m = X.shape[0]
        lanes = torch.cat([X.real, X.imag]) if X.is_complex() else X
        if not self.dtype.is_complex:
            Y = self._real_lanes(self.dataT, lanes)      # (2m, n), one launch
            return torch.complex(Y[:m], Y[m:])
        Yr = self._real_lanes(self.dataT_re, lanes)
        Yi = self._real_lanes(self.dataT_im, lanes)
        if X.is_complex():      # (Ar + i Ai)(xr + i xi)
            return torch.complex(Yr[:m] - Yi[m:], Yr[m:] + Yi[:m])
        return torch.complex(Yr, Yi)

    def _real_lanes(self, blocks, X):
        """One multi-vector product of the real block set ``blocks`` with
        the real lane stack X (m, n): B3, or its split form at "high"."""
        dtype = torch.promote_types(blocks.dtype, X.dtype)
        Xp = self._pad(X, dtype)                     # (m, npad)
        if self.dataT_hi is not None and dtype == torch.float32:
            Yp = bsr_matmat_split(self.dataT_hi, self.dataT_lo, self.idx, Xp,
                                  **self._cols)
        else:
            Yp = bsr_matmat(blocks.to(dtype), self.idx, Xp, **self._cols)
        return Yp[:, :self.n]

    def diagonal(self):
        """diag(H): the (i, i) entries of the diagonal blocks (block rows
        where idx[r, t] == r).  A row block has none of its own."""
        if not self.square:
            raise ValueError("a row block (ncb != nrb) has no diagonal; take "
                             "the rows of the whole operator's")
        nrb = self.dataT.shape[0]
        is_diag = self.idx == torch.arange(nrb, dtype=self.idx.dtype,
                                           device=self.idx.device)[:, None]
        # a block's diagonal is transpose-invariant, so dataT serves directly
        blk = torch.diagonal(self.dataT, dim1=2, dim2=3)    # (nrb, nbpr, B)
        d = torch.where(is_diag[:, :, None], blk, 0).sum(dim=1)
        return d.reshape(-1)[:self.n]

    def to_dense(self):
        nrb, nbpr, B, _ = self.dataT.shape
        out = torch.zeros((self.n_padded, self.ncb * B), dtype=self.dtype,
                          device=self.dataT.device)
        idx = self.idx.cpu().numpy()
        for r in range(nrb):
            for t in range(nbpr):
                c = int(idx[r, t])
                out[r * B:(r + 1) * B, c * B:(c + 1) * B] += self.dataT[r, t].T
        return out[:self.n, :self.n_cols]


# ----------------------------------------------------------------------------
# Plain PyTorch versions: the CPU path and the kernels' references
# ----------------------------------------------------------------------------
def bsr_matvec_plain(dataT, idx, xp):
    """Single RHS: gather the needed x blocks, one batched einsum over the
    transposed blocks (counterpart of the JAX ``_bsr_matvec_xla``).  xp
    (ncb*B,) -> (nrb*B,): square or a row block alike."""
    B = dataT.shape[2]
    gathered = xp.reshape(-1, B)[idx.long()]          # (nrb, nbpr, B)
    return torch.einsum("rtji,rtj->ri", dataT, gathered).reshape(-1)


def bsr_matvec_split_plain(hiT, loT, idx, xp, acc=torch.float32):
    """bf16x3 ("high") single RHS: x split into bf16 hi/lo like the blocks,
    y = xh·Bh + xh·Bl + xl·Bh accumulated in ``acc`` (each bf16 product is
    exact in f32).  ``acc=torch.float64`` sums the same products in f64: the
    exact split product, the oracle the split kernels are held to."""
    B = hiT.shape[2]
    xh = xp.to(torch.bfloat16).to(acc)
    xl = (xp.to(acc) - xh).to(torch.bfloat16).to(acc)
    ii = idx.long()
    gh = xh.reshape(-1, B)[ii]
    gl = xl.reshape(-1, B)[ii]
    hi = hiT.to(acc)
    lo = loT.to(acc)
    y = torch.einsum("rtji,rtj->ri", hi, gh)
    y = y + torch.einsum("rtji,rtj->ri", lo, gh)
    y = y + torch.einsum("rtji,rtj->ri", hi, gl)
    return y.reshape(-1)


def bsr_matmat_plain(dataT, idx, Xp):
    """Multi-RHS: Xp (m, ncb*B) -> (m, nrb*B); the gathered x blocks carry
    the RHS axis (counterpart of the JAX ``_bsr_matmat_xla``)."""
    B = dataT.shape[2]
    m = Xp.shape[0]
    gathered = Xp.reshape(m, -1, B)[:, idx.long()]    # (m, nrb, nbpr, B)
    return torch.einsum("rtji,mrtj->mri", dataT, gathered).reshape(m, -1)


def bsr_matmat_split_plain(hiT, loT, idx, Xp, acc=torch.float32):
    """bf16x3 ("high") multi-RHS: each row of Xp (m, npad) split into bf16
    hi/lo as :func:`bsr_matvec_split_plain` splits one vector, the same
    three products per row, accumulated in ``acc`` (f64: the exact split
    product)."""
    B = hiT.shape[2]
    m = Xp.shape[0]
    xh = Xp.to(torch.bfloat16).to(acc)
    xl = (Xp.to(acc) - xh).to(torch.bfloat16).to(acc)
    ii = idx.long()
    gh = xh.reshape(m, -1, B)[:, ii]
    gl = xl.reshape(m, -1, B)[:, ii]
    hi = hiT.to(acc)
    lo = loT.to(acc)
    y = torch.einsum("rtji,mrtj->mri", hi, gh)
    y = y + torch.einsum("rtji,mrtj->mri", lo, gh)
    y = y + torch.einsum("rtji,mrtj->mri", hi, gl)
    return y.reshape(m, -1)


# ----------------------------------------------------------------------------
# Kernel wrappers: CPU -> plain version, CUDA -> hand-written kernel or raise
# ----------------------------------------------------------------------------
def _check_launch(blocks, idx, xp, lanes=False, ncb=None):
    """Validate what the kernels take: x of shape (ncb*B,), or (m, ncb*B)
    for ``lanes``, with ncb = nrb (square) unless the caller names the
    number of block columns (a row block; its block-column ids were
    checked below ncb when its operator was built, not here), and m lanes
    whose grid fits (nrb * ceil(m / 64) CTAs on the x axis).  Returns (nrb,
    ncb, nbpr, B)."""
    nrb, nbpr, B, B2 = blocks[0].shape
    if B != B2 or not 1 <= B <= _MAX_BLOCK:
        raise ValueError(f"block size {B} (x{B2}) not supported: the kernel "
                         f"needs square blocks with 1 <= B <= {_MAX_BLOCK}")
    if nrb < 1 or nbpr < 1:
        raise ValueError(f"empty operator {tuple(blocks[0].shape)}")
    if tuple(idx.shape) != (nrb, nbpr) or idx.dtype != torch.int32:
        raise ValueError(f"idx must be int32 {(nrb, nbpr)}, got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    ncb = nrb if ncb is None else int(ncb)
    if ncb < 1:
        raise ValueError(f"ncb={ncb} block columns")
    if lanes:
        max_lanes = _MAX_GRID_X // nrb * _LANE_CHUNK
        if xp.ndim != 2 or xp.shape[1] != ncb * B \
                or not 1 <= xp.shape[0] <= max_lanes:
            raise ValueError(f"X must be (m, {ncb * B}) with 1 <= m <= "
                             f"{max_lanes}, got {tuple(xp.shape)}")
    elif tuple(xp.shape) != (ncb * B,):
        raise ValueError(f"x must be ({ncb * B},), got {tuple(xp.shape)}")
    for t in (*blocks, idx, xp):
        if t.device != xp.device:
            raise ValueError(f"tensors on {t.device} and {xp.device}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors only")
    for t in blocks[1:]:
        if t.shape != blocks[0].shape:
            raise ValueError("hi and lo blocks differ in shape")
    return nrb, ncb, nbpr, B


def _launch_b3(name, dataT, idx, Xp, lanes, ncb=None):
    """Launch B3's kernel (``csrc/bsr_spmm.cu``) on the padded x (ncb*B,)
    or lane stack (m, ncb*B) and count the launch under ``name``."""
    nrb, ncb, nbpr, B = _check_launch((dataT,), idx, Xp, lanes=lanes,
                                      ncb=ncb)
    if dataT.dtype not in (torch.float32, torch.float64) \
            or Xp.dtype != dataT.dtype:
        raise TypeError(f"{name} takes f32 or f64 data and x of the same "
                        f"type, got {dataT.dtype} and {Xp.dtype}")
    lib = bsr_spmm_library()
    fn = lib.bsr_spmm_f32 if dataT.dtype == torch.float32 else lib.bsr_spmm_f64
    Y = Xp.new_empty((Xp.shape[0], nrb * B) if lanes else (nrb * B,))
    code = launch(fn, Xp.device, dataT.data_ptr(), idx.data_ptr(),
                   Xp.data_ptr(), Y.data_ptr(), nrb, ncb, nbpr, B,
                   Xp.shape[0] if lanes else 1)
    check(lib, code, name)
    launches[name] += 1
    return Y


def bsr_matvec(dataT, idx, xp, ncb=None):
    """B1: ``y = A x`` for the padded x (ncb*B,) -> (nrb*B,), f32 or f64
    (port of ``eigensolvers_tpu/ops/sparse.py::_bsr_matvec_pallas``): the
    kernel of :func:`bsr_matmat` with one vector, counted as
    ``bsr_spmv``.  The kernel reads x by block-column id and writes y by
    block row, so a row block launches as the square operator does.
    ``ncb``, in every wrapper: the block columns of x, nrb unless a row
    block's operator (which checked its ids below ncb) names them."""
    if xp.device.type == "cpu":
        return bsr_matvec_plain(dataT, idx, xp)
    if xp.device.type != "cuda":
        raise ValueError(f"no bsr_spmv kernel for device {xp.device}")
    return _launch_b3("bsr_spmv", dataT, idx, xp, lanes=False, ncb=ncb)


def _launch_split(name, hiT, loT, idx, Xp, lanes, ncb=None):
    """Launch the bf16x3 tensor-core kernel on the padded x (ncb*B,) or
    lane stack (m, ncb*B) and count the launch under ``name``."""
    nrb, ncb, nbpr, B = _check_launch((hiT, loT), idx, Xp, lanes=lanes,
                                      ncb=ncb)
    if hiT.dtype != torch.bfloat16 or loT.dtype != torch.bfloat16 \
            or Xp.dtype != torch.float32:
        raise TypeError(f"{name} takes bf16 hi/lo blocks and f32 x, got "
                        f"{hiT.dtype}, {loT.dtype}, {Xp.dtype}")
    lib = bsr_spmm_split_library()
    Y = Xp.new_empty((Xp.shape[0], nrb * B) if lanes else (nrb * B,))
    code = launch(lib.bsr_spmm_split_f32, Xp.device, hiT.data_ptr(),
                   loT.data_ptr(), idx.data_ptr(), Xp.data_ptr(),
                   Y.data_ptr(), nrb, ncb, nbpr, B,
                   Xp.shape[0] if lanes else 1)
    check(lib, code, name)
    launches[name] += 1
    return Y


def bsr_matvec_split(hiT, loT, idx, xp, ncb=None):
    """B2: the "high" precision (bf16x3) f32 SpMV from pre-split bf16 blocks
    (port of ``eigensolvers_tpu/ops/sparse.py::_bsr_matvec_pallas_split``):
    the tensor-core kernel of :func:`bsr_matmat_split` with one vector."""
    if xp.device.type == "cpu":
        return bsr_matvec_split_plain(hiT, loT, idx, xp)
    if xp.device.type != "cuda":
        raise ValueError(f"no bsr_spmv_split kernel for device {xp.device}")
    return _launch_split("bsr_spmv_split", hiT, loT, idx, xp, lanes=False,
                         ncb=ncb)


def bsr_matmat(dataT, idx, Xp, ncb=None):
    """B3: ``Y = (A X^T)^T`` for the padded lane stack Xp (m, ncb*B) ->
    (m, nrb*B), f32 or f64, in one launch (replaces the JAX package's XLA
    ``eigensolvers_tpu/ops/sparse.py::_bsr_matmat_xla``)."""
    if Xp.device.type == "cpu":
        return bsr_matmat_plain(dataT, idx, Xp)
    if Xp.device.type != "cuda":
        raise ValueError(f"no bsr_spmm kernel for device {Xp.device}")
    return _launch_b3("bsr_spmm", dataT, idx, Xp, lanes=True, ncb=ncb)


def bsr_matmat_split(hiT, loT, idx, Xp, ncb=None):
    """B3 at "high": the bf16x3 f32 product of pre-split bf16 blocks with
    the lane stack Xp (m, ncb*B), in one launch on the tensor cores
    (``csrc/bsr_spmm_split.cu``)."""
    if Xp.device.type == "cpu":
        return bsr_matmat_split_plain(hiT, loT, idx, Xp)
    if Xp.device.type != "cuda":
        raise ValueError(f"no bsr_spmm_split kernel for device {Xp.device}")
    return _launch_split("bsr_spmm_split", hiT, loT, idx, Xp, lanes=True,
                         ncb=ncb)


class BandedOperator(AbstractOperator):
    """Banded operator: H[i, i + offsets[j]] = bands[j, i].

    The matvec is gather-free: each diagonal contributes
    ``bands[j] * x[d_j : d_j + n]`` of a zero-padded x, static slices and
    elementwise products, for one vector or a lane stack alike.  The
    natural form for 1-D DVR chains (kinetic + potential) and
    finite-difference Hamiltonians."""

    def __init__(self, bands, offsets, n: int, device=None):
        super().__init__()
        bands = as_tensor(bands, device)
        self.offsets = tuple(int(o) for o in offsets)
        self.n = int(n)
        if tuple(bands.shape) != (len(self.offsets), self.n):
            raise ValueError(f"bands must be {(len(self.offsets), self.n)}, "
                             f"got {tuple(bands.shape)}")
        self.register_buffer("bands", bands)

    @classmethod
    def from_dense(cls, H, tol: float = 0.0, device=None) -> "BandedOperator":
        H = np.asarray(H)
        n = H.shape[0]
        offsets = []
        bands = []
        for d in range(-(n - 1), n):
            diag = np.diagonal(H, offset=d)
            if np.any(np.abs(diag) > tol):
                offsets.append(d)
                row = np.zeros(n, H.dtype)
                if d >= 0:
                    row[:n - d] = diag
                else:
                    row[-d:] = diag
                bands.append(row)
        return cls(np.stack(bands), offsets, n, device=device)

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.bands.dtype

    @property
    def bandwidth(self):
        return max(abs(o) for o in self.offsets)

    def matvec_lanes(self, X):
        """Rows of X (..., n) -> (..., n)."""
        dtype = torch.promote_types(self.dtype, X.dtype)
        w = self.bandwidth
        Xp = torch.nn.functional.pad(X.to(dtype), (w, w))
        Y = torch.zeros_like(Xp[..., :self.n])
        for j, d in enumerate(self.offsets):
            Y = Y + self.bands[j].to(dtype) * Xp[..., w + d:w + d + self.n]
        return Y

    def matvec(self, x):
        return self.matvec_lanes(x.reshape(-1)).reshape(x.shape)

    def diagonal(self):
        if 0 in self.offsets:
            return self.bands[self.offsets.index(0)]
        return torch.zeros(self.n, dtype=self.dtype, device=self.bands.device)

    def to_dense(self):
        out = torch.zeros((self.n, self.n), dtype=self.dtype,
                          device=self.bands.device)
        i = torch.arange(self.n, device=self.bands.device)
        for j, d in enumerate(self.offsets):
            ok = (i + d >= 0) & (i + d < self.n)
            out[i[ok], i[ok] + d] = self.bands[j][i[ok]]
        return out
