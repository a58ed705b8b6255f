"""Operator abstractions for the torch compute path.

The reference passes raw ndarrays / scipy ``LinearOperator``s into the
algorithms (reference: numpyVector.py:147-154).  Here operators are
``torch.nn.Module``s with a ``matvec`` method that hold their arrays as
buffers, so ``.to(device)`` moves them and ``state_dict()`` saves them.

* :class:`DenseOperator` — explicit (n, n) matrix; matvec is a GEMV.
* :class:`DiagonalOperator` — diagonal matrix; matvec is elementwise.
* :class:`SumOfProductOperator`, :class:`GroupedSoPOperator` —
  H = Σ_s c_s ⊗_d A^{(d,s)} (the ``.op`` molecule models); matvec is a
  sequence of mode-wise batched contractions, never the full matrix.
* :class:`CallableOperator` — a matvec callable with a shape (the analogue
  of a scipy ``LinearOperator``, which ``as_operator`` wraps in one).
* :class:`PaddedOperator` — an operator zero-embedded into a larger space.
* :class:`~eigensolvers_tpu_torch.ops.sparse.BSROperator` — block-ELL
  sparse matrix, applied by the hand-written CUDA kernels.

Every operator applies to one vector (``matvec``) and to a lane stack of m
vectors, one per row (``matvec_lanes``: (m, n) -> (m, n)), the layout the
batched solves keep their vectors in; ``matmat`` (n, m) -> (n, m) is the
lane apply of the transpose.

Every operator's applies are counted in one place: the outermost
``matvec`` or ``matvec_lanes`` call under way, by any path, runs in the
span ``es.apply`` and is counted by its lanes and type as well
(``es.apply.m<lanes>.<dtype>``); the row-by-row default of
``matvec_lanes`` is counted as ``es.apply.rowwise``
(:mod:`~eigensolvers_tpu_torch.utils.profiling`).
"""

from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np
import torch

from ..utils.profiling import count, span

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


_apply_depth = 0          # 1 while an apply is under way


def _counted(fn, single):
    """The apply ``fn`` (a ``matvec`` or ``matvec_lanes``) in the span
    ``es.apply``, counted by lanes and type, when no apply is under way;
    an apply inside another (a composite's inner operator, the row-by-row
    default) runs as it is."""
    @functools.wraps(fn)
    def apply(self, x):
        global _apply_depth
        if _apply_depth:
            return fn(self, x)
        _apply_depth = 1
        try:
            with span("es.apply") as s:
                y = fn(self, x)
        finally:
            _apply_depth = 0
        dtype = torch.promote_types(x.dtype, getattr(self, "dtype", x.dtype))
        count(f"es.apply.m{1 if single else x.shape[0]}."
              f"{str(dtype).removeprefix('torch.')}", s.seconds)
        return y
    return apply


class AbstractOperator(torch.nn.Module):
    """Minimal operator protocol: shape, dtype, matvec, to_dense.  A
    subclass's own ``matvec`` and ``matvec_lanes`` are counted (see the
    module docstring)."""

    shape: tuple
    dtype: torch.dtype

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        _count_applies(cls)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.matvec(x)

    def matvec_lanes(self, X: torch.Tensor) -> torch.Tensor:
        """Apply to each row of a lane stack: X (m, n) -> (m, n).  The
        default applies the matvec row by row (``es.apply.rowwise``);
        operators with a fused multi-vector path override it."""
        with span("es.apply.rowwise"):
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


def _count_applies(cls):
    for name, single in (("matvec", True), ("matvec_lanes", False)):
        if name in cls.__dict__:
            setattr(cls, name, _counted(cls.__dict__[name], single))


_count_applies(AbstractOperator)


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


def _apply_terms(factor_batch, modes, xt, dims):
    """sum_s (⊗_{d in modes} f_d[s]) applied to xt (shape ``dims``), the
    identity on the other modes: for each active mode one batched
    contraction over the term axis s (``einsum`` on the (S, pre, n_d,
    post) view, which PyTorch runs as one batched matmul), then the term
    sum.  The (S, n) intermediate is what ``term_chunk`` bounds."""
    S = factor_batch[0].shape[0]
    xb = xt.expand((S,) + tuple(dims))
    for mode, f in zip(modes, factor_batch):
        dt = torch.promote_types(f.dtype, xb.dtype)
        f = f.to(dt)
        require_true_fp32(f)
        pre = int(np.prod(dims[:mode]))
        post = int(np.prod(dims[mode + 1:]))
        xb = torch.einsum("sij,spjq->spiq", f,
                          xb.reshape(S, pre, dims[mode], post).to(dt))
    return xb.reshape((S,) + tuple(dims)).sum(dim=0)


def _factor_diagonals(factor_batch):
    """sum_s ⊗_d diag(f_d[s]) as one (prod n_d,) vector, never H itself."""
    diags = [torch.diagonal(f, dim1=1, dim2=2) for f in factor_batch]
    acc = diags[0]                                        # (S, n_0)
    for dg in diags[1:]:
        acc = (acc[:, :, None] * dg[:, None, :]).reshape(acc.shape[0], -1)
    return acc.sum(dim=0)


class SumOfProductOperator(AbstractOperator):
    """H = Σ_{s<nSum} ⊗_{d<nDim} A^{(d,s)}, with coefficients folded into the
    first non-identity factor of each term (the JAX package's
    ``SumOfProductOperator``).

    Stored as per-mode stacked factor tensors ``factors[d]`` of shape
    (nSum, n_d, n_d), so a matvec is, for each mode d, one batched
    contraction over the term axis (PyTorch einsum, cuBLAS on the card;
    the JAX package left it to XLA, so no hand-written kernel).  Memory:
    the batched intermediate is (nSum, n); ``term_chunk`` bounds it to
    (term_chunk, n) by looping over chunks of terms."""

    def __init__(self, factors, dims=None, term_chunk: Optional[int] = None,
                 precision="highest", device=None):
        """:param factors: list over modes d of arrays (nSum, n_d, n_d).
        :param term_chunk: if set, the matvec loops over the term axis in
            chunks of this size.  Terms are zero-padded to a multiple of
            the chunk size at construction (zero terms contribute nothing).
        :param precision: operator precision name (see
            :func:`resolve_precision`; every name applies at true fp32 or
            better on the card).
        :param device: where numpy factors go (default: the card)."""
        super().__init__()
        factors = [as_tensor(f, device) for f in factors]
        if not factors:
            raise ValueError("a sum of products needs at least one mode")
        nSum = factors[0].shape[0]
        for f in factors:
            if f.ndim != 3 or f.shape[0] != nSum or f.shape[1] != f.shape[2]:
                raise ValueError(f"bad factor shape {tuple(f.shape)}")
        self._true_nSum = nSum
        if term_chunk is not None and term_chunk < nSum:
            pad = (-nSum) % term_chunk
            if pad:
                factors = [torch.cat([f, f.new_zeros((pad,) + f.shape[1:])])
                           for f in factors]
        else:
            term_chunk = None
        self.term_chunk = term_chunk
        self.precision = resolve_precision(precision)
        for d, f in enumerate(factors):
            self.register_buffer(f"factor{d}", f)
        self._nDim = len(factors)

    @classmethod
    def from_terms(cls, nDim: int, dims, terms, dtype=None,
                   term_chunk: Optional[int] = None, device=None):
        """Build from a list of terms ``(coeff, {mode_index: matrix})``;
        unspecified modes get identity factors, the coefficient is folded into
        the first mode's factor."""
        dtype = dtype or np.float64
        stacked = []
        for d in range(nDim):
            eye = np.eye(dims[d], dtype=dtype)
            mats = []
            for (coeff, facs) in terms:
                m = np.asarray(facs.get(d, eye), dtype=dtype)
                if d == min(facs.keys(), default=0):
                    m = m * coeff
                mats.append(m)
            stacked.append(np.stack(mats))
        return cls(stacked, term_chunk=term_chunk, device=device)

    @property
    def factors(self):
        return [getattr(self, f"factor{d}") for d in range(self._nDim)]

    @property
    def nDim(self):
        return self._nDim

    @property
    def nSum(self):
        return self.factor0.shape[0]

    @property
    def dims(self):
        return tuple(int(f.shape[1]) for f in self.factors)

    @property
    def shape(self):
        n = int(np.prod(self.dims))
        return (n, n)

    @property
    def dtype(self):
        return functools.reduce(torch.promote_types,
                                [f.dtype for f in self.factors])

    def matvec(self, x):
        dims = self.dims
        xt = x.reshape(dims)
        modes = range(self._nDim)
        if self.term_chunk is None:
            y = _apply_terms(self.factors, modes, xt, dims)
        else:
            y = None
            for c in range(0, self.nSum, self.term_chunk):
                part = _apply_terms([f[c:c + self.term_chunk]
                                     for f in self.factors], modes, xt, dims)
                y = part if y is None else y + part
        return y.reshape(x.shape)

    def diagonal(self):
        """diag(⊗_d A_d) = ⊗_d diag(A_d), summed over terms — one (n,)
        vector (same footprint as a state), never materializing H."""
        return _factor_diagonals(self.factors)

    def to_dense(self):
        """H as a dense matrix via Kronecker products (small oracle
        problems only)."""
        fs = [f.cpu().numpy() for f in self.factors]
        n = self.shape[0]
        out = np.zeros((n, n), dtype=np.result_type(*fs))
        for s in range(self.nSum):
            out += functools.reduce(np.kron, [f[s] for f in fs])
        return torch.as_tensor(out, device=self.factor0.device)


class GroupedSoPOperator(AbstractOperator):
    """Sum-of-products operator with terms grouped by mode support (the JAX
    package's ``GroupedSoPOperator``).

    Physical SoP Hamiltonians touch only a few modes per term (the MCTDH
    .op models: 2-4 active of 12 modes); applying stacked identity factors
    for the inactive modes (as :class:`SumOfProductOperator` does) wastes
    most of the flops.  Here terms sharing the same active-mode set form
    one batched group, a matvec contracts only the active modes of each
    group, and pure-identity terms collapse to one scalar.

    ``factors`` (property) materializes the full identity-padded stacked
    form for consumers that need it."""

    def __init__(self, dims, groups, id_coeff=0.0, precision="highest",
                 device=None):
        """:param groups: list of (modes tuple, [per-active-mode arrays
        (S_g, n_d, n_d)]); :param id_coeff: summed coefficient of the pure
        identity terms; :param precision: operator precision name (see
        :func:`resolve_precision`); :param device: where numpy arrays go
        (default: the card)."""
        super().__init__()
        self._dims = tuple(int(d) for d in dims)
        self._modes = []
        for gi, (modes, facs) in enumerate(groups):
            self._modes.append(tuple(int(m) for m in modes))
            for j, f in enumerate(facs):
                self.register_buffer(f"g{gi}f{j}", as_tensor(f, device))
        if device is None and self._modes:
            device = self.g0f0.device
        self.register_buffer("id_coeff", as_tensor(id_coeff, device))
        self.precision = resolve_precision(precision)

    @classmethod
    def from_terms(cls, nDim: int, dims, terms, dtype=None, device=None):
        """Same term format as :meth:`SumOfProductOperator.from_terms`."""
        dtype = dtype or np.float64
        by_support = {}
        id_coeff = 0.0
        for coeff, facs in terms:
            modes = tuple(sorted(facs.keys()))
            if not modes:
                id_coeff += coeff
                continue
            by_support.setdefault(modes, []).append((coeff, facs))
        groups = []
        for modes, group_terms in sorted(by_support.items()):
            stacked = []
            for j, d in enumerate(modes):
                mats = []
                for coeff, facs in group_terms:
                    m = np.asarray(facs[d], dtype=dtype)
                    if j == 0:
                        m = m * coeff
                    mats.append(m)
                stacked.append(np.stack(mats))
            if len(modes) == 1:
                # single-mode group: Σ_s c_s A_s is ONE matrix — presumming
                # cuts the flops and the (S, n) intermediate by S
                stacked = [stacked[0].sum(axis=0, keepdims=True)]
            groups.append((modes, stacked))
        return cls(dims, groups, id_coeff=np.asarray(id_coeff, dtype),
                   device=device)

    @property
    def groups(self):
        return [(modes, [getattr(self, f"g{gi}f{j}")
                         for j in range(len(modes))])
                for gi, modes in enumerate(self._modes)]

    @property
    def dims(self):
        return self._dims

    @property
    def nDim(self):
        return len(self._dims)

    @property
    def nSum(self):
        return sum(facs[0].shape[0] for _, facs in self.groups) + 1

    @property
    def shape(self):
        n = int(np.prod(self._dims))
        return (n, n)

    @property
    def dtype(self):
        return functools.reduce(
            torch.promote_types,
            [f.dtype for _, facs in self.groups for f in facs],
            self.id_coeff.dtype)

    @property
    def factors(self):
        """Full identity-padded stacked factors; the pure-identity
        coefficient becomes one extra term."""
        out = []
        for d, n in enumerate(self._dims):
            eye = np.eye(n)
            mats = []
            for modes, facs in self.groups:
                S_g = facs[0].shape[0]
                if d in modes:
                    mats.append(facs[modes.index(d)].cpu().numpy())
                else:
                    mats.append(np.broadcast_to(eye, (S_g, n, n)))
            idc = np.broadcast_to(eye, (1, n, n)).copy()
            if d == 0:
                idc = idc * self.id_coeff.cpu().numpy()
            mats.append(idc)
            out.append(torch.as_tensor(np.concatenate(mats),
                                       device=self.id_coeff.device))
        return out

    def matvec(self, x):
        """Per group: batched mode-wise contractions of its active modes,
        trailing term sum; plus the identity terms' scalar."""
        dims = self._dims
        xt = x.reshape(dims)
        y = self.id_coeff * xt
        for modes, facs in self.groups:
            y = y + _apply_terms(facs, modes, xt, dims)
        return y.reshape(x.shape)

    def diagonal(self):
        """Per group: the Kronecker product of the active-mode factor
        diagonals, broadcast over the inactive modes; identity terms add
        id_coeff."""
        dims = self._dims
        out = torch.full(dims, float(self.id_coeff), dtype=self.dtype,
                         device=self.id_coeff.device)
        for modes, facs in self.groups:
            shape = [dims[d] if d in modes else 1 for d in range(len(dims))]
            out = out + _factor_diagonals(facs).reshape(shape)
        return out.reshape(-1)

    def to_dense(self):
        n = self.shape[0]
        groups = [(modes, [f.cpu().numpy() for f in facs])
                  for modes, facs in self.groups]
        dt = np.result_type(*(f.dtype for _, facs in groups for f in facs)) \
            if groups else np.float64
        out = self.id_coeff.cpu().numpy().astype(dt) * np.eye(n, dtype=dt)
        for modes, facs in groups:
            for s in range(facs[0].shape[0]):
                mats = [facs[modes.index(d)][s] if d in modes
                        else np.eye(nd, dtype=dt)
                        for d, nd in enumerate(self._dims)]
                out = out + functools.reduce(np.kron, mats)
        return torch.as_tensor(out, device=self.id_coeff.device)


def fuse_sop_terms(dims, terms, target: int = 256):
    """Coarsen a sum-of-products term list by fusing consecutive modes into
    super-modes of dimension ~``target`` (the JAX package's
    ``fuse_sop_terms``, same semantics): each term's factor on a super-mode
    is the Kronecker product of its per-mode factors (identity for inactive
    modes *within an active super-mode*; super-modes with no active mode
    stay absent, so the grouped apply's flop saving survives).  More flops
    per contraction (2*n*196 against 2*n*14 for CH3CN's 14x14 pairs) for
    fewer, wider contractions.  The JAX package chose 256 for the TPU's
    (8, 128) tiles; on the H100 the choice is measured (ROADMAP,
    "Re-decide on the H100").

    :param dims: per-mode dimensions
    :param terms: list of (coeff, {mode_index: matrix})
    :param target: aim for fused dimensions <= max(target, largest single
        mode)
    :returns: (fused_dims, fused_terms, partition) — partition is the list
        of original-mode index groups, for callers that need to map back
    """
    parts: List[List[int]] = []
    cur: List[int] = []
    prod = 1
    for d, nd in enumerate(dims):
        if cur and prod * int(nd) > target:
            parts.append(cur)
            cur, prod = [d], int(nd)
        else:
            cur.append(d)
            prod *= int(nd)
    if cur:
        parts.append(cur)
    fused_dims, fused_terms = regroup_sop_terms(dims, terms, parts)
    return fused_dims, fused_terms, parts


def regroup_sop_terms(dims, terms, parts):
    """Regroup SoP terms onto an ARBITRARY partition of the modes.

    Generalizes the consecutive fusing of :func:`fuse_sop_terms`: ``parts``
    is a list of original-mode index groups, one per new (super-)mode, in
    any order; a group's factor is the Kronecker product of its members'
    factors (identity for inactive members).  An EMPTY group yields a
    dimension-1 virtual mode that no term touches (tree layouts with
    coordinate-free internal nodes).

    :returns: (new_dims, new_terms)
    """
    seen = sorted(d for p in parts for d in p)
    if seen != list(range(len(dims))):
        raise ValueError(
            f"parts must partition modes 0..{len(dims) - 1}, got {parts}")
    new_dims = [int(np.prod([dims[d] for d in p])) if p else 1
                for p in parts]
    new_terms = []
    for coeff, facs in terms:
        new_facs = {}
        for pi, p in enumerate(parts):
            if not any(d in facs for d in p):
                continue
            mats = [np.asarray(facs[d]) if d in facs else np.eye(dims[d])
                    for d in p]
            new_facs[pi] = functools.reduce(np.kron, mats)
        new_terms.append((coeff, new_facs))
    return new_dims, new_terms


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


def operator_device(op: AbstractOperator) -> torch.device:
    """The device an operator's arrays live on; for one that holds none (a
    :class:`CallableOperator`), :func:`default_device`."""
    for t in op.buffers():
        return t.device
    return default_device()


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
