"""Block-sparse and banded operators; the block-sparse one applies through
hand-written CUDA kernels.

:class:`BSROperator` — block-ELL layout (fixed number of BxB blocks per
block-row, zero-padded): ``dataT (nrb, nbpr, B, B)``, ``idx (nrb, nbpr)``.
The matvec gathers whole B-blocks of x, so every flop is a dense (B, B)
block product.  Block data is stored per-block TRANSPOSED, the layout every
apply path consumes (``dataT[r, t, j, i] = H[r*B + i, idx[r, t]*B + j]``),
so no apply re-transposes the whole array.

Execution paths, chosen by the device of the tensors alone:

* single vector (:meth:`BSROperator.matvec`) on a CUDA tensor: the
  ``bsr_spmv`` kernel (``csrc/bsr_spmv.cu``, B1), the port of the JAX
  package's Pallas kernel ``_bsr_matvec_pallas``, at "highest" or
  "default" for f32 or f64; at ``precision="high"`` on f32 data the bf16x3
  ``bsr_spmv_split`` kernel (B2, port of ``_bsr_matvec_pallas_split``);
* a lane stack of m vectors (:meth:`BSROperator.matvec_lanes`, under
  ``matmat`` and every batched solve) on a CUDA tensor: the ``bsr_spmm``
  kernel (``csrc/bsr_spmm.cu``, B3), which replaces the JAX package's XLA
  ``_bsr_matmat_xla``; at "high" on f32 data its bf16x3 form
  ``bsr_spmm_split``, so a lane sees the same operator as a single vector;
* CPU tensor: the plain PyTorch versions (gather + einsum), which are also
  the references the kernels are tested against.

A CUDA tensor reaches its kernel or raises; nothing falls back to the plain
version.

:class:`BandedOperator` (diagonals at fixed offsets) is plain PyTorch on
every device: static shifted slices, no gather (the JAX package leaves it
to XLA too).
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels import bsr_spmm_library, bsr_spmv_library, check
from .operators import AbstractOperator, as_tensor, resolve_precision

#: Kernel launches since the last :func:`reset_launch_counts`, by kernel.
#: Each CUDA wrapper adds one where it launches its kernel, and nowhere else.
launches = {"bsr_spmv": 0, "bsr_spmv_split": 0, "bsr_spmm": 0,
            "bsr_spmm_split": 0}

_MAX_BLOCK = 1024   # one thread per block row: the CUDA block-size limit
_MAX_LANES = 8 * 65535   # B3 runs chunks of 8 vectors on the grid's y axis


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


class BSROperator(AbstractOperator):
    """Block-ELL sparse operator (see module docstring).

    ``dataT`` is the TRANSPOSED block storage, the layout the JAX package's
    ``BSROperator.dataT`` holds; use :meth:`from_dense` / :meth:`from_scipy`
    to build from a matrix.  ``precision="high"`` on f32 data precomputes
    the bf16 hi/lo split of the blocks (same bytes as f32) for the split
    kernel; "highest" and "default" apply in the data's own precision."""

    def __init__(self, dataT, idx, n: int, precision="highest", device=None):
        super().__init__()
        dataT = as_tensor(dataT, device)
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
        if not 0 <= int(idx.min()) <= int(idx.max()) < nrb:
            raise ValueError(f"block-column ids must lie in [0, {nrb})")
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

    # -- properties ---------------------------------------------------------
    @property
    def block_size(self) -> int:
        return int(self.dataT.shape[2])

    @property
    def n_padded(self) -> int:
        return int(self.dataT.shape[0] * self.block_size)

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.dataT.dtype

    # -- construction -------------------------------------------------------
    @classmethod
    def from_dense(cls, H, block_size: int = 128, drop_tol: float = 0.0,
                   precision="highest", device=None) -> "BSROperator":
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
        return cls(np.swapaxes(data, 2, 3), idx, n, precision=precision,
                   device=device)

    @classmethod
    def from_scipy(cls, H, block_size: int = 128, precision="highest",
                   device=None) -> "BSROperator":
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
        return cls(dataT, idx, n, precision=precision, device=device)

    # -- application --------------------------------------------------------
    def _pad(self, x: torch.Tensor, dtype) -> torch.Tensor:
        """Zero-pad the last axis from n to n_padded, contiguous."""
        xp = x.to(dtype)
        if self.n_padded != self.n:
            xp = torch.nn.functional.pad(xp, (0, self.n_padded - self.n))
        return xp.contiguous()

    def matvec(self, x):
        flat = x.reshape(-1)
        dtype = torch.promote_types(self.dtype, flat.dtype)
        xp = self._pad(flat, dtype)
        if self.dataT_hi is not None and dtype == torch.float32:
            yp = bsr_matvec_split(self.dataT_hi, self.dataT_lo, self.idx, xp)
        else:
            yp = bsr_matvec(self.dataT.to(dtype), self.idx, xp)
        return yp[:self.n].reshape(x.shape)

    def matvec_lanes(self, X):
        """Apply to each row of the lane stack X (m, n) -> (m, n) in one
        multi-vector product: the block data is read once for all m rows.
        At "high" on f32 data this is the bf16x3 product, like ``matvec``."""
        if X.ndim != 2 or X.shape[1] != self.n:
            raise ValueError(f"bad lane stack shape {tuple(X.shape)}")
        dtype = torch.promote_types(self.dtype, X.dtype)
        Xp = self._pad(X, dtype)                     # (m, npad)
        if self.dataT_hi is not None and dtype == torch.float32:
            Yp = bsr_matmat_split(self.dataT_hi, self.dataT_lo, self.idx, Xp)
        else:
            Yp = bsr_matmat(self.dataT.to(dtype), self.idx, Xp)
        return Yp[:, :self.n]

    def diagonal(self):
        """diag(H): the (i, i) entries of the diagonal blocks (block rows
        where idx[r, t] == r)."""
        nrb = self.dataT.shape[0]
        is_diag = self.idx == torch.arange(nrb, dtype=self.idx.dtype,
                                           device=self.idx.device)[:, None]
        # a block's diagonal is transpose-invariant, so dataT serves directly
        blk = torch.diagonal(self.dataT, dim1=2, dim2=3)    # (nrb, nbpr, B)
        d = torch.where(is_diag[:, :, None], blk, 0).sum(dim=1)
        return d.reshape(-1)[:self.n]

    def to_dense(self):
        nrb, nbpr, B, _ = self.dataT.shape
        out = torch.zeros((self.n_padded, self.n_padded), dtype=self.dtype,
                          device=self.dataT.device)
        idx = self.idx.cpu().numpy()
        for r in range(nrb):
            for t in range(nbpr):
                c = int(idx[r, t])
                out[r * B:(r + 1) * B, c * B:(c + 1) * B] += self.dataT[r, t].T
        return out[:self.n, :self.n]


# ----------------------------------------------------------------------------
# Plain PyTorch versions: the CPU path and the kernels' references
# ----------------------------------------------------------------------------
def bsr_matvec_plain(dataT, idx, xp):
    """Single RHS: gather the needed x blocks, one batched einsum over the
    transposed blocks (counterpart of the JAX ``_bsr_matvec_xla``)."""
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
    """Multi-RHS: Xp (m, npad) -> (m, npad); the gathered x blocks carry the
    RHS axis (counterpart of the JAX ``_bsr_matmat_xla``)."""
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
def _check_launch(blocks, idx, xp, lanes=False):
    """Validate what the kernels take (x of shape (nrb*B,), or (m, nrb*B)
    for ``lanes``); returns (nrb, nbpr, B)."""
    nrb, nbpr, B, B2 = blocks[0].shape
    if B != B2 or not 1 <= B <= _MAX_BLOCK:
        raise ValueError(f"block size {B} (x{B2}) not supported: the kernel "
                         f"needs square blocks with 1 <= B <= {_MAX_BLOCK}")
    if nrb < 1 or nbpr < 1:
        raise ValueError(f"empty operator {tuple(blocks[0].shape)}")
    if tuple(idx.shape) != (nrb, nbpr) or idx.dtype != torch.int32:
        raise ValueError(f"idx must be int32 {(nrb, nbpr)}, got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    if lanes:
        if xp.ndim != 2 or xp.shape[1] != nrb * B \
                or not 1 <= xp.shape[0] <= _MAX_LANES:
            raise ValueError(f"X must be (m, {nrb * B}) with 1 <= m <= "
                             f"{_MAX_LANES}, got {tuple(xp.shape)}")
    elif tuple(xp.shape) != (nrb * B,):
        raise ValueError(f"x must be ({nrb * B},), got {tuple(xp.shape)}")
    for t in (*blocks, idx, xp):
        if t.device != xp.device:
            raise ValueError(f"tensors on {t.device} and {xp.device}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors only")
    for t in blocks[1:]:
        if t.shape != blocks[0].shape:
            raise ValueError("hi and lo blocks differ in shape")
    return nrb, nbpr, B


def bsr_matvec(dataT, idx, xp):
    """B1: ``y = A x`` for the padded x (nrb*B,), f32 or f64 (port of
    ``eigensolvers_tpu/ops/sparse.py::_bsr_matvec_pallas``)."""
    if xp.device.type == "cpu":
        return bsr_matvec_plain(dataT, idx, xp)
    if xp.device.type != "cuda":
        raise ValueError(f"no bsr_spmv kernel for device {xp.device}")
    nrb, nbpr, B = _check_launch((dataT,), idx, xp)
    if dataT.dtype not in (torch.float32, torch.float64) \
            or xp.dtype != dataT.dtype:
        raise TypeError(f"bsr_spmv takes f32 or f64 data and x of the same "
                        f"type, got {dataT.dtype} and {xp.dtype}")
    lib = bsr_spmv_library()
    fn = lib.bsr_spmv_f32 if dataT.dtype == torch.float32 else lib.bsr_spmv_f64
    y = torch.empty_like(xp)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(dataT.data_ptr(), idx.data_ptr(), xp.data_ptr(),
                  y.data_ptr(), nrb, nbpr, B, stream)
    check(lib, code, "bsr_spmv")
    launches["bsr_spmv"] += 1
    return y


def bsr_matvec_split(hiT, loT, idx, xp):
    """B2: the "high" precision (bf16x3) f32 SpMV from pre-split bf16 blocks
    (port of ``eigensolvers_tpu/ops/sparse.py::_bsr_matvec_pallas_split``)."""
    if xp.device.type == "cpu":
        return bsr_matvec_split_plain(hiT, loT, idx, xp)
    if xp.device.type != "cuda":
        raise ValueError(f"no bsr_spmv_split kernel for device {xp.device}")
    nrb, nbpr, B = _check_launch((hiT, loT), idx, xp)
    if hiT.dtype != torch.bfloat16 or loT.dtype != torch.bfloat16 \
            or xp.dtype != torch.float32:
        raise TypeError(f"bsr_spmv_split takes bf16 hi/lo blocks and f32 x, "
                        f"got {hiT.dtype}, {loT.dtype}, {xp.dtype}")
    lib = bsr_spmv_library()
    y = torch.empty_like(xp)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.bsr_spmv_split_f32(hiT.data_ptr(), loT.data_ptr(),
                                      idx.data_ptr(), xp.data_ptr(),
                                      y.data_ptr(), nrb, nbpr, B, stream)
    check(lib, code, "bsr_spmv_split")
    launches["bsr_spmv_split"] += 1
    return y


def bsr_matmat(dataT, idx, Xp):
    """B3: ``Y = (A X^T)^T`` for the padded lane stack Xp (m, nrb*B), f32 or
    f64, in one launch (replaces the JAX package's XLA
    ``eigensolvers_tpu/ops/sparse.py::_bsr_matmat_xla``)."""
    if Xp.device.type == "cpu":
        return bsr_matmat_plain(dataT, idx, Xp)
    if Xp.device.type != "cuda":
        raise ValueError(f"no bsr_spmm kernel for device {Xp.device}")
    nrb, nbpr, B = _check_launch((dataT,), idx, Xp, lanes=True)
    if dataT.dtype not in (torch.float32, torch.float64) \
            or Xp.dtype != dataT.dtype:
        raise TypeError(f"bsr_spmm takes f32 or f64 data and X of the same "
                        f"type, got {dataT.dtype} and {Xp.dtype}")
    lib = bsr_spmm_library()
    fn = lib.bsr_spmm_f32 if dataT.dtype == torch.float32 else lib.bsr_spmm_f64
    Y = torch.empty_like(Xp)
    with torch.cuda.device(Xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(dataT.data_ptr(), idx.data_ptr(), Xp.data_ptr(),
                  Y.data_ptr(), nrb, nbpr, B, Xp.shape[0], stream)
    check(lib, code, "bsr_spmm")
    launches["bsr_spmm"] += 1
    return Y


def bsr_matmat_split(hiT, loT, idx, Xp):
    """B3 at "high": the bf16x3 f32 product of pre-split bf16 blocks with
    the lane stack Xp (m, nrb*B), in one launch."""
    if Xp.device.type == "cpu":
        return bsr_matmat_split_plain(hiT, loT, idx, Xp)
    if Xp.device.type != "cuda":
        raise ValueError(f"no bsr_spmm_split kernel for device {Xp.device}")
    nrb, nbpr, B = _check_launch((hiT, loT), idx, Xp, lanes=True)
    if hiT.dtype != torch.bfloat16 or loT.dtype != torch.bfloat16 \
            or Xp.dtype != torch.float32:
        raise TypeError(f"bsr_spmm_split takes bf16 hi/lo blocks and f32 X, "
                        f"got {hiT.dtype}, {loT.dtype}, {Xp.dtype}")
    lib = bsr_spmm_library()
    Y = torch.empty_like(Xp)
    with torch.cuda.device(Xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.bsr_spmm_split_f32(hiT.data_ptr(), loT.data_ptr(),
                                      idx.data_ptr(), Xp.data_ptr(),
                                      Y.data_ptr(), nrb, nbpr, B,
                                      Xp.shape[0], stream)
    check(lib, code, "bsr_spmm_split")
    launches["bsr_spmm_split"] += 1
    return Y


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
