"""Operator abstractions for the torch compute path.

The reference passes raw ndarrays / scipy ``LinearOperator``s into the
algorithms (reference: numpyVector.py:147-154).  Here operators are
``torch.nn.Module``s with a ``matvec`` method that hold their arrays as
buffers, so ``.to(device)`` moves them and ``state_dict()`` saves them.

* :class:`DenseOperator` — explicit (n, n) matrix; matvec is a GEMV.
* :class:`DiagonalOperator` — diagonal matrix; matvec is elementwise.
* :class:`CallableOperator` — a matvec callable with a shape (the analogue
  of a scipy ``LinearOperator``, which ``as_operator`` wraps in one).
* :class:`PaddedOperator` — an operator zero-embedded into a larger space.
* :class:`~eigensolvers_tpu_torch.ops.sparse.BSROperator` — block-ELL
  sparse matrix, applied by the hand-written CUDA kernels.

Every operator applies to one vector (``matvec``) and to a lane stack of m
vectors, one per row (``matvec_lanes``: (m, n) -> (m, n)), the layout the
batched solves keep their vectors in; ``matmat`` (n, m) -> (n, m) is the
lane apply of the transpose.
"""

from __future__ import annotations

import numpy as np
import torch

PRECISIONS = ("default", "high", "highest")


def resolve_precision(p) -> str:
    """Normalise an operator precision name ("default", "high" or
    "highest"; None means "default").

    On the card every name computes in true fp32 or better: "highest" and
    "default" apply f32 data in f32 with TF32 off, and "high" routes a
    sparse operator to the bf16x3 split kernel (f32-grade, ~1e-6 relative).
    TF32 (about three decimal digits) is never used: an eigensolver's
    matvec is the operator definition, and a TF32 floor would cap every
    solve tolerance and eigenvalue residual."""
    if p is None:
        return "default"
    name = getattr(p, "name", p)          # accepts jax.lax.Precision values
    name = str(name).lower()
    if name not in PRECISIONS:
        raise ValueError(f"unknown precision {p!r}; available: {PRECISIONS}")
    return name


def require_true_fp32(t: torch.Tensor) -> None:
    """Refuse a CUDA fp32 product while PyTorch is allowed to run it in
    TF32: the "highest" contract is true fp32 on the card."""
    if (t.is_cuda and t.dtype in (torch.float32, torch.complex64)
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: fp32 products "
            "would run in TF32; set it to False for true fp32")


def default_device(device=None) -> torch.device:
    """``device`` if given, else the card: the entry points run on CUDA
    unless the caller asks for the CPU.  Without a CUDA device and without
    ``device`` this raises instead of falling back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device=\"cpu\" (or a CPU tensor) to run on the CPU")
    return torch.device("cuda")


def as_tensor(a, device=None, dtype=None) -> torch.Tensor:
    """numpy array / sequence / tensor -> tensor on ``device``.  A tensor
    keeps its own device when ``device`` is None; anything else goes to
    :func:`default_device`, the card."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device if device is not None else a.device,
                    dtype=dtype)
    arr = np.require(a, requirements=["C", "W"])     # copies only if needed
    return torch.as_tensor(arr, device=default_device(device), dtype=dtype)


class AbstractOperator(torch.nn.Module):
    """Minimal operator protocol: shape, dtype, matvec, to_dense."""

    shape: tuple
    dtype: torch.dtype

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.matvec(x)

    def matvec_lanes(self, X: torch.Tensor) -> torch.Tensor:
        """Apply to each row of a lane stack: X (m, n) -> (m, n).  The
        default applies the matvec row by row; operators with a fused
        multi-vector path override it."""
        return torch.stack([self.matvec(x) for x in X])

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        """Apply to m stacked RHS: X (n, m) -> (n, m)."""
        return self.matvec_lanes(X.T).T

    def to_dense(self) -> torch.Tensor:
        """Materialize as a dense (n, n) tensor (oracle/small paths only)."""
        raise NotImplementedError

    def diagonal(self):
        """diag(H) as an (n,) tensor, or None when it is not cheaply
        available (used for Jacobi preconditioning of the shifted solves)."""
        return None

    # Allow ``operator @ tensor`` in user code.
    def __matmul__(self, x):
        return self.matvec(x)


class DenseOperator(AbstractOperator):
    """Explicit dense matrix operator; the workhorse for n ≲ 10^5."""

    def __init__(self, mat, precision="highest", device=None):
        super().__init__()
        mat = as_tensor(mat, device)
        if mat.ndim != 2 or mat.shape[0] != mat.shape[1]:
            raise ValueError(f"need square matrix, got {tuple(mat.shape)}")
        self.register_buffer("mat", mat)
        self.precision = resolve_precision(precision)

    @property
    def shape(self):
        return tuple(self.mat.shape)

    @property
    def dtype(self):
        return self.mat.dtype

    def matvec(self, x):
        flat = x.reshape(-1)
        dtype = torch.promote_types(self.mat.dtype, flat.dtype)
        require_true_fp32(flat.to(dtype))
        y = self.mat.to(dtype) @ flat.to(dtype)
        return y.reshape(x.shape)

    def matvec_lanes(self, X):
        dtype = torch.promote_types(self.mat.dtype, X.dtype)
        require_true_fp32(X.to(dtype))
        return X.to(dtype) @ self.mat.to(dtype).T

    def to_dense(self):
        return self.mat

    def diagonal(self):
        return torch.diagonal(self.mat)


class DiagonalOperator(AbstractOperator):
    """Diagonal operator; matvec is elementwise."""

    def __init__(self, diag, device=None):
        super().__init__()
        self.register_buffer("diag", as_tensor(diag, device).reshape(-1))

    @property
    def shape(self):
        n = self.diag.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.diag.dtype

    def matvec(self, x):
        return (self.diag * x.reshape(-1)).reshape(x.shape)

    def matvec_lanes(self, X):
        return self.diag * X

    def to_dense(self):
        return torch.diag(self.diag)

    def diagonal(self):
        return self.diag


class CallableOperator(AbstractOperator):
    """Wraps a matvec callable ``fn`` of a tensor (the analogue of a scipy
    ``LinearOperator``).  ``dtype`` is a torch dtype or anything numpy reads
    as one; the result of ``fn`` comes back as a tensor on the input's
    device."""

    def __init__(self, fn, shape, dtype=torch.float64):
        super().__init__()
        self.fn = fn
        self._shape = tuple(int(s) for s in shape)
        if not isinstance(dtype, torch.dtype):
            dtype = torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype
        self._dtype = dtype

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self._dtype

    def matvec(self, x):
        return as_tensor(self.fn(x), x.device).reshape(x.shape)

    def to_dense(self):
        n = self._shape[0]
        return self.matmat(torch.eye(n, dtype=self._dtype))


class PaddedOperator(AbstractOperator):
    """Zero-embeds an (n, n) operator into (n_pad, n_pad): the matvec keeps
    the padding lanes exactly zero (y[n:] = 0), so Krylov iterations started
    from zero-padded b never leave the logical subspace.  The shifted
    operator (sigma*I - H_pad) acts as sigma*I on the padding block, which
    makes the *exact* dense path singular at sigma == 0, so exact solves
    slice back to the logical block instead."""

    def __init__(self, op: AbstractOperator, n_pad: int):
        super().__init__()
        if n_pad < op.shape[0]:
            raise ValueError(f"n_pad={n_pad} < n={op.shape[0]}")
        self.op = op
        self.n_pad = int(n_pad)

    @property
    def shape(self):
        return (self.n_pad, self.n_pad)

    @property
    def dtype(self):
        return self.op.dtype

    def _embed(self, Y):
        return torch.nn.functional.pad(Y, (0, self.n_pad - self.op.shape[0]))

    def matvec(self, x):
        return self._embed(self.op.matvec(x[:self.op.shape[0]]))

    def matvec_lanes(self, X):
        return self._embed(self.op.matvec_lanes(X[:, :self.op.shape[0]]))

    def to_dense(self):
        d = self.op.to_dense()
        return self._embed(torch.nn.functional.pad(
            d, (0, 0, 0, self.n_pad - d.shape[0])))

    def diagonal(self):
        d = self.op.diagonal()
        return None if d is None else self._embed(d)


def as_operator(H, device=None) -> AbstractOperator:
    """Coerce a user-provided operator-like object into an AbstractOperator.

    Accepts: AbstractOperator (returned as-is), 2-D numpy array or tensor
    (→ DenseOperator), scipy.sparse matrix (→ BSROperator), and objects with
    ``.matvec`` and ``.shape`` such as a scipy ``LinearOperator``
    (→ CallableOperator; their matvec takes and returns numpy arrays, so
    each apply passes through the host).  ``device`` places a new operator
    (default: the tensor's device, else the card; see
    :func:`default_device`)."""
    if isinstance(H, AbstractOperator):
        return H
    if isinstance(H, (np.ndarray, torch.Tensor)) and H.ndim == 2:
        return DenseOperator(H, device=device)
    import scipy.sparse as sp
    if sp.issparse(H):
        from .sparse import BSROperator
        return BSROperator.from_scipy(H, device=device)
    if hasattr(H, "matvec") and hasattr(H, "shape"):
        dtype = getattr(H, "dtype", None)
        return CallableOperator(lambda x: H.matvec(x.detach().cpu().numpy()),
                                H.shape, np.float64 if dtype is None else dtype)
    raise TypeError(f"cannot interpret {type(H)} as an operator")
