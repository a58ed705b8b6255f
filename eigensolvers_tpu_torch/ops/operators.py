"""Operator abstractions for the torch compute path.

The reference passes raw ndarrays / scipy ``LinearOperator``s into the
algorithms (reference: numpyVector.py:147-154).  Here operators are
``torch.nn.Module``s with a ``matvec`` method that hold their arrays as
buffers, so ``.to(device)`` moves them and ``state_dict()`` saves them.

* :class:`DenseOperator` — explicit (n, n) matrix; matvec is a GEMV.
* :class:`DiagonalOperator` — diagonal matrix; matvec is elementwise.
* :class:`SumOfProductOperator`, :class:`GroupedSoPOperator` —
  H = Σ_s c_s ⊗_d A^{(d,s)} (the ``.op`` molecule models); matvec is a
  sequence of mode-wise contractions, never the full matrix (the grouped
  operator's narrow modes through the hand-written CUDA kernel
  ``csrc/sop_contract.cu``, :func:`sop_pair` and :func:`sop_contract`).
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

import collections
import ctypes
import functools
import itertools
from typing import List, Optional

import numpy as np
import torch

from ..utils.profiling import count, span
from .kernels import check, launch, sop_contract_library

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


def _factor_diagonals(factor_batch, coeffs=None):
    """sum_s c_s ⊗_d diag(f_d[s]) as one (prod n_d,) vector, never H
    itself (c_s = 1 without ``coeffs``)."""
    diags = [torch.diagonal(f, dim1=1, dim2=2) for f in factor_batch]
    acc = diags[0]                                        # (S, n_0)
    if coeffs is not None:
        acc = acc * coeffs[:, None]
    for dg in diags[1:]:
        acc = (acc[:, :, None] * dg[:, None, :]).reshape(acc.shape[0], -1)
    return acc.sum(dim=0)


#: Launches of the sum-of-products contraction kernel since the last
#: :func:`reset_launch_counts`, by role: each CUDA call of
#: :func:`sop_contract` (``sop_contract``) or :func:`sop_pair`
#: (``sop_pair``) adds one per launch, and nothing else does.
launches = {"sop_contract": 0, "sop_pair": 0}

#: The widest mode the contraction kernel takes (``csrc/sop_contract.cu``
#: keeps a thread's N sums in registers).  A group whose terms' modes are
#: all at most this wide is applied by the kernel mode by mode (2N flops
#: for each 8-byte element read: memory-bound); a wider factor, such as the
#: presummed 289-wide factor of a fused super-mode, is a cuBLAS GEMM (578
#: flops an element: compute-bound, where cuBLAS is near the card's peak).
SOP_MAX_WIDTH = 32
_SOP_MAX_TERMS = 32                 # terms a launch (the kernel's table)
_SOP_FACTOR_BYTES = 48 * 1024       # factors a launch keeps in shared memory


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def sop_contract_plain(F, xs, ys, pre, post, sum_out=False, beta=False):
    """:func:`sop_contract` in plain PyTorch: the route of CPU tensors and
    the reference the kernel is held to."""
    N = F.shape[-1]
    acc = None
    for s, (f, x) in enumerate(zip(F, xs)):
        t = torch.einsum("ij,lpjq->lpiq", f, x.reshape(-1, pre, N, post))
        if sum_out:
            acc = t if acc is None else acc + t
        else:
            ys[s].copy_(t.reshape(ys[s].shape))
    if sum_out:
        y = ys[0]
        if beta:
            y.add_(acc.reshape(y.shape))
        else:
            y.copy_(acc.reshape(y.shape))


def sop_terms_per_launch(N: int, itemsize: int) -> int:
    """How many (N, N) factors one kernel launch holds."""
    padded = -(-N // 4) * 4
    return max(1, min(_SOP_MAX_TERMS, _SOP_FACTOR_BYTES
                      // (N * padded * itemsize)))


def sop_contract(F, xs, ys, pre, post, sum_out=False, beta=False):
    """The stacked-factor mode contraction of the grouped sum-of-products
    apply, on the (pre, N, post) view of lane stacks (m, pre * N * post):
    term s maps ``xs[s]`` to ``t_s[l, p, i, q] = sum_j F[s, i, j] xs[s][l,
    p, j, q]``; then ``ys[s] = t_s`` for every s (a fan-out from one input,
    or in place, ``xs[s] is ys[s]``), or with ``sum_out`` the term sum
    ``ys[0] = sum_s t_s``, added to ``ys[0]`` with ``beta``.

    CPU tensors take :func:`sop_contract_plain`.  CUDA tensors launch the
    kernel (``csrc/sop_contract.cu``; f32 or f64, N <= ``SOP_MAX_WIDTH``,
    inputs, outputs and factors of one type, contiguous, on one device) or
    raise; each launch is counted in ``launches``, and the contractions (a
    term on a lane) as ``es.sop.kernel``."""
    if F.device.type != "cuda":
        return sop_contract_plain(F, xs, ys, pre, post, sum_out, beta)
    S, N = F.shape[0], F.shape[-1]
    if F.dtype not in (torch.float32, torch.float64) or F.ndim != 3 \
            or F.shape[1] != N or not F.is_contiguous():
        raise TypeError(f"sop_contract takes a contiguous f32 or f64 (S, N, "
                        f"N) factor stack, got {F.dtype} {tuple(F.shape)}")
    if not 1 <= N <= SOP_MAX_WIDTH:
        raise ValueError(f"sop_contract takes modes 1..{SOP_MAX_WIDTH} wide, "
                         f"got {N}")
    if len(xs) != S or len(ys) != (1 if sum_out else S):
        raise ValueError(f"{S} factors need {S} inputs and "
                         f"{1 if sum_out else S} outputs, got {len(xs)} and "
                         f"{len(ys)}")
    m, n = xs[0].shape
    if n != pre * N * post or not 1 <= m <= 65535:
        raise ValueError(f"lane stack {tuple(xs[0].shape)} is not (m <= "
                         f"65535, {pre} * {N} * {post})")
    for t in (*xs, *ys):
        if t.device != F.device or t.dtype != F.dtype \
                or tuple(t.shape) != (m, n) or not t.is_contiguous():
            raise ValueError("sop_contract takes contiguous (m, n) lane "
                             "stacks of the factors' type and device")
    lib = sop_contract_library()
    fn = lib.sop_contract_f64 if F.dtype == torch.float64 \
        else lib.sop_contract_f32
    step = sop_terms_per_launch(N, F.element_size())
    for s0 in range(0, S, step):
        k = min(step, S - s0)
        addrs = (ctypes.c_longlong * k)(*(x.data_ptr()
                                          for x in xs[s0:s0 + k]))
        outs = ys[:1] if sum_out else ys[s0:s0 + k]
        oaddrs = (ctypes.c_longlong * len(outs))(*(y.data_ptr()
                                                   for y in outs))
        code = launch(fn, F.device, F[s0].data_ptr(), addrs, oaddrs, k, N,
                      pre, post, m, n, int(sum_out),
                      int(bool(beta) or s0 > 0))
        check(lib, code, "sop_contract")
        launches["sop_contract"] += 1
    count("es.sop.kernel", calls=S * m)


def sop_pair_plain(A, B, x, outs, y, pre, mid, post, beta=False):
    """:func:`sop_pair` in plain PyTorch: the route of CPU tensors and the
    reference the kernel is held to."""
    Na, Nb = A.shape[-1], B.shape[-1]
    X = x.reshape(-1, pre, Na, mid, Nb, post)
    acc = None
    for s in range(A.shape[0]):
        t = torch.einsum("ij,lpjrvq->lpirvq", A[s], X)
        t = torch.einsum("kv,lpirvq->lpirkq", B[s], t)
        if s < len(outs):
            outs[s].copy_(t.reshape(outs[s].shape))
        else:
            acc = t if acc is None else acc + t
    if acc is not None:
        if beta:
            y.add_(acc.reshape(y.shape))
        else:
            y.copy_(acc.reshape(y.shape))


def sop_pair(A, B, x, outs, y, pre, mid, post, beta=False):
    """The pair role of the grouped sum-of-products apply: S terms on two
    modes a < b, on the (pre, Na, mid, Nb, post) view of the lane stack x
    (m, n).  Term s maps x to ``t_s = B_s (A_s x)`` (``A_s`` on mode a
    first, then ``B_s`` on mode b); the first ``len(outs)`` terms write
    ``outs[s] = t_s`` (a longer term's slot), and the others sum into y,
    ``y = sum_s t_s``, added to y with ``beta``.

    CPU tensors take :func:`sop_pair_plain`.  CUDA tensors launch the
    kernel (``csrc/sop_contract.cu``; f32 or f64, modes at most
    ``SOP_MAX_WIDTH`` wide, inputs, outputs and factors of one type,
    contiguous, on one device; once for each run of terms that fits a
    block's shared memory) or raise; each launch is counted in
    ``launches``, and the contractions (a term on a lane) as
    ``es.sop.pair``."""
    if A.device.type != "cuda":
        return sop_pair_plain(A, B, x, outs, y, pre, mid, post, beta)
    S, Na, Nb = A.shape[0], A.shape[-1], B.shape[-1]
    for F, N in ((A, Na), (B, Nb)):
        if F.dtype not in (torch.float32, torch.float64) or F.ndim != 3 \
                or tuple(F.shape) != (S, N, N) or not F.is_contiguous():
            raise TypeError(f"sop_pair takes contiguous f32 or f64 (S, N, N) "
                            f"factor stacks of S terms, got {F.dtype} "
                            f"{tuple(F.shape)}")
    if B.dtype != A.dtype or max(Na, Nb) > SOP_MAX_WIDTH:
        raise ValueError(f"sop_pair takes two factor stacks of one type on "
                         f"modes 1..{SOP_MAX_WIDTH} wide, got {A.dtype} "
                         f"{Na} and {B.dtype} {Nb}")
    nslot = len(outs)
    if nslot > S or (nslot < S and y is None):
        raise ValueError(f"{S} terms take at most {S} slots and a y for the "
                         f"rest, got {nslot} slots and y {y is not None}")
    m, n = x.shape
    if n != pre * Na * mid * Nb * post or not 1 <= m <= 65535:
        raise ValueError(f"lane stack {tuple(x.shape)} is not (m <= 65535, "
                         f"{pre} * {Na} * {mid} * {Nb} * {post})")
    for t in (x, *outs, *([y] if nslot < S else [])):
        if t.device != A.device or t.dtype != A.dtype \
                or tuple(t.shape) != (m, n) or not t.is_contiguous():
            raise ValueError("sop_pair takes contiguous (m, n) lane stacks "
                             "of the factors' type and device")
    lib = sop_contract_library()
    fn = lib.sop_pair_f64 if A.dtype == torch.float64 else lib.sop_pair_f32
    addrs = (ctypes.c_longlong * max(1, nslot))(*(o.data_ptr() for o in outs))
    made = ctypes.c_int(0)
    code = launch(fn, A.device, A.data_ptr(), B.data_ptr(), x.data_ptr(),
                  addrs, y.data_ptr() if y is not None else None, S, nslot,
                  Na, Nb, pre, mid, post, m, n, int(bool(beta)),
                  ctypes.byref(made))
    launches["sop_pair"] += made.value
    check(lib, code, "sop_pair")
    count("es.sop.pair", calls=S * m)


def kron_compress(As, Bs):
    """sum_s As[s] (x) Bs[s] as the fewest Kronecker products that give the
    same operator in exact arithmetic: R of them, R the numerical rank of
    sum_s vec(As[s]) vec(Bs[s])^T (a term whose factor on one mode repeats
    another's up to a scale, as q1 q3 and q1 q3^2 share q1, folds into it).
    Computed in f64 and returned in the factors' type; a single term is
    returned as it is."""
    if len(As) < 2:
        return list(As), list(Bs)
    dt, (Na, Nb) = As[0].dtype, (As[0].shape[-1], Bs[0].shape[-1])
    P = torch.stack([a.reshape(-1) for a in As], 1).double()
    Q = torch.stack([b.reshape(-1) for b in Bs], 1).double()
    qp, rp = torch.linalg.qr(P)
    qq, rq = torch.linalg.qr(Q)
    u, sig, vh = torch.linalg.svd(rp @ rq.T)
    R = int((sig > sig[0] * len(As) * torch.finfo(torch.float64).eps).sum())
    A = (qp @ (u[:, :R] * sig[:R])).T.reshape(R, Na, Na)
    B = (qq @ vh[:R].T).T.reshape(R, Nb, Nb)
    return [a.to(dt) for a in A], [b.to(dt) for b in B]


def plan_terms(terms):
    """The kernel's launches for a sum of products ``terms`` [(c, {mode: (N,
    N) factor})], each term on one mode or more, applied in ascending mode
    order (as the batched route and the JAX package apply it: the same
    rounding in f32), c going into the first factor applied.

    A term of two modes or more starts with its two lowest modes a < b in
    the pair role: one pair launch for each (a, b) reads x once for all its
    terms, sums the two-mode terms into y (as the fewest Kronecker products
    that give their sum, :func:`kron_compress`) and writes each longer
    term's slot (a lane stack of scratch).  Such a term's other modes follow
    in ascending order, each but the last in place in its slot (a middle),
    the last summing it into y (a fan-in: one launch per mode, the one-mode
    terms of that mode presummed and read from x).

    :returns: (slots, [launch]): a launch is ("pair", a, b, [factors on a],
        [factors on b], [slots of its first terms]; the other terms sum into
        y) or (mode, [factors], [slot, or None for x], [slots, or None for
        the sum into y])"""
    order = [sorted(f) for _, f in terms]
    slot = {k: s for s, k in enumerate(k for k, o in enumerate(order)
                                       if len(o) > 2)}

    def factor(k, pos):
        c, f = terms[k]
        return f[order[k][pos]] * c if pos == 0 else f[order[k][pos]]

    plan = []
    for a, b in sorted({tuple(o[:2]) for o in order if len(o) > 1}):
        ks = [k for k in slot if order[k][:2] == [a, b]]
        sums = [k for k, o in enumerate(order) if o == [a, b]]
        fa, fb = kron_compress([factor(k, 0) for k in sums],
                               [factor(k, 1) for k in sums])
        plan.append(("pair", a, b, [factor(k, 0) for k in ks] + fa,
                     [factor(k, 1) for k in ks] + fb, [slot[k] for k in ks]))
    for pos in range(2, max(map(len, order), default=0) - 1):
        here = [k for k in slot if len(order[k]) > pos + 1]
        for d in sorted({order[k][pos] for k in here}):
            ks = [k for k in here if order[k][pos] == d]
            plan.append((d, [factor(k, pos) for k in ks],
                         [slot[k] for k in ks], [slot[k] for k in ks]))
    last = {k: o[-1] for k, o in enumerate(order) if len(o) != 2}
    for b in sorted(set(last.values())):
        single = [k for k in last if k not in slot and last[k] == b]
        many = [k for k in slot if last[k] == b]
        facs = [sum(factor(k, 0) for k in single)] if single else []
        facs += [factor(k, len(order[k]) - 1) for k in many]
        plan.append((b, facs, [None] * bool(single)
                     + [slot[k] for k in many], None))
    return len(slot), plan


def _share_plans(groups, budget):
    """Kernel groups [(dims, terms)] as few plans: a group joins the first
    plan on the same modes while the plan's slots (its terms of three modes
    or more) stay within ``budget``, so that a pair launch or a fan-in
    serves the terms of every group it holds."""
    plans = []
    for dims, terms in groups:
        into = next((k for k, (d, t) in enumerate(plans) if list(d) ==
                     list(dims) and sum(len(f) > 2 for _, f in t + terms)
                     <= budget), None)
        if into is None:
            plans.append((dims, terms))
        else:
            plans[into] = (dims, plans[into][1] + terms)
    return plans


def _gemm_mode(F, X, Y, pre, post, accumulate):
    """Y (+)= F applied on one mode of width N of every lane of X ((m, n),
    viewed as (m * pre, N, post)): one cuBLAS GEMM, in place in Y."""
    mp, N = X.shape[0] * pre, F.shape[0]
    require_true_fp32(F)
    if post == 1:
        x2, y2 = X.view(mp, N), Y.view(mp, N)
        if accumulate:
            y2.addmm_(x2, F.T)
        else:
            torch.mm(x2, F.T, out=y2)
        return
    x3, y3, Fe = X.view(mp, N, post), Y.view(mp, N, post), F.expand(mp, N, N)
    if accumulate:
        y3.baddbmm_(Fe, x3)
    else:
        torch.bmm(Fe, x3, out=y3)


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
    one group, an apply contracts only the active modes of each group, and
    pure-identity terms collapse to one scalar.

    A fused operator (``physical``: its modes are Kronecker products of
    consecutive physical modes) keeps, for a group that spans two fused
    modes or more, its terms' physical factors (``groups`` builds the fused
    factors from them on demand): most fused factors are kron(A, I) or
    kron(I, B), and a term touches two to four physical modes of ~17.

    The apply, planned once at construction, with the lanes of a stack as
    one batch dimension throughout (``matvec_lanes``), takes per group one
    of three routes, by what the group holds:

    * every factor real and at most ``SOP_MAX_WIDTH`` wide (physical
      groups, and the groups of an unfused operator): the kernel's
      contractions (:func:`plan_terms`): a term's two lowest modes in one
      pass (:func:`sop_pair`), its others mode by mode
      (:func:`sop_contract`); in f64 the groups on the same modes share a
      plan (:func:`_share_plans`); its scratch lane stacks are at most as
      many vectors as the largest group has terms (the (S, n) stack of the
      batched route), so lanes are taken a few at a time where a plan has
      many;
    * one wider mode (the presummed single-super-mode groups): one cuBLAS
      GEMM (``es.sop.gemm``), in place in y;
    * several modes, one wider (or complex factors): the batched
      contractions of :func:`_apply_terms`, a lane at a time.

    The identity terms' scalar goes into the first GEMM's factor, else
    into the first fan-in of a kernel group, else y starts as id * x.

    ``factors`` (property) materializes the full identity-padded stacked
    form for consumers that need it."""

    def __init__(self, dims, groups, id_coeff=0.0, precision="highest",
                 device=None, physical=None):
        """:param groups: list of (modes tuple, [per-active-mode arrays
        (S_g, n_d, n_d)], coefficients folded), or, with ``physical``,
        (modes, [per physical mode of those modes' parts, arrays (S_g, n,
        n), identity where a term does not act], coefficients (S_g,));
        :param id_coeff: summed coefficient of the pure identity terms;
        :param precision: operator precision name (see
        :func:`resolve_precision`); :param device: where numpy arrays go
        (default: the card); :param physical: (physical dims, parts): the
        consecutive physical modes of each mode of ``dims``."""
        super().__init__()
        self._dims = tuple(int(d) for d in dims)
        self._modes, self._physical = [], set()
        if physical is not None:
            pdims, parts = physical
            self._pdims = tuple(int(d) for d in pdims)
            self._parts = [list(p) for p in parts]
            if [d for p in self._parts for d in p] != list(range(len(pdims)))\
                    or [int(np.prod([pdims[d] for d in p]))
                        for p in self._parts] != list(self._dims):
                raise ValueError(f"parts {parts} of {tuple(pdims)} do not "
                                 f"fuse to {self._dims}")
        for gi, (modes, facs, *coeffs) in enumerate(groups):
            self._modes.append(tuple(int(m) for m in modes))
            for j, f in enumerate(facs):
                self.register_buffer(f"g{gi}f{j}", as_tensor(f, device))
            if coeffs:
                if physical is None:
                    raise ValueError("a group of physical factors needs "
                                     "physical=(dims, parts)")
                self._physical.add(gi)
                self.register_buffer(f"g{gi}c", as_tensor(coeffs[0], device))
        if device is None and self._modes:
            device = self.g0f0.device
        self.register_buffer("id_coeff", as_tensor(id_coeff, device))
        self.precision = resolve_precision(precision)
        self._plan()

    @classmethod
    def from_terms(cls, nDim: int, dims, terms, dtype=None, device=None,
                   parts=None):
        """Same term format as :meth:`SumOfProductOperator.from_terms`.

        ``parts`` (consecutive runs of the modes of ``dims``, e.g.
        :func:`fuse_parts`) fuses each run into one mode, as
        :func:`fuse_sop_terms` does: the operator's dims are the runs'; a
        group of terms that touches one run is presummed into one fused
        factor, and one that touches several keeps its physical factors
        when they are all at most ``SOP_MAX_WIDTH`` wide."""
        dtype = dtype or np.float64
        owner = {d: d for d in range(nDim)} if parts is None else \
            {d: i for i, p in enumerate(parts) for d in p}
        by_support = {}
        id_coeff = 0.0
        for coeff, facs in terms:
            modes = tuple(sorted({owner[d] for d in facs}))
            if not modes:
                id_coeff += coeff
                continue
            by_support.setdefault(modes, []).append((coeff, facs))
        groups = []
        for modes, group_terms in sorted(by_support.items()):
            if parts is None:
                groups.append(cls._stacked(modes, group_terms, dtype))
                continue
            pmodes = [d for mo in modes for d in parts[mo]]
            if len(modes) > 1 and all(dims[d] <= SOP_MAX_WIDTH
                                      for d in pmodes):
                groups.append((modes, [np.stack([
                    np.asarray(facs[d], dtype=dtype) if d in facs
                    else np.eye(dims[d], dtype=dtype)
                    for _, facs in group_terms]) for d in pmodes],
                    np.asarray([c for c, _ in group_terms], dtype=dtype)))
                continue
            fused = [(c, {d: np.asarray(m, dtype=dtype)
                          for d, m in facs.items()})
                     for c, facs in regroup_sop_terms(dims, group_terms,
                                                      parts)[1]]
            groups.append(cls._stacked(modes, fused, dtype))
        physical = None
        if parts is not None:
            physical = (dims, parts)
            dims = [int(np.prod([dims[d] for d in p])) for p in parts]
        return cls(dims, groups, id_coeff=np.asarray(id_coeff, dtype),
                   device=device, physical=physical)

    @staticmethod
    def _stacked(modes, group_terms, dtype):
        """A group's (modes, stacked factors), the coefficient in the first
        mode's; a single-mode group presummed."""
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
        return modes, stacked

    def _stacks(self, gi):
        n = len(self._modes[gi]) if gi not in self._physical else \
            sum(len(self._parts[m]) for m in self._modes[gi])
        return [getattr(self, f"g{gi}f{j}") for j in range(n)]

    @property
    def groups(self):
        """(modes, [per-mode stacked factors (S_g, n_d, n_d)]) per group,
        coefficients folded; a physical group's fused factors are built
        here, as :func:`fuse_sop_terms` builds them."""
        out = []
        for gi, modes in enumerate(self._modes):
            facs = self._stacks(gi)
            if gi in self._physical:
                stacks = [f.cpu().numpy() for f in facs]
                coeffs = getattr(self, f"g{gi}c").cpu().numpy()
                fused, k = [], 0
                for j, mode in enumerate(modes):
                    part = stacks[k:k + len(self._parts[mode])]
                    k += len(part)
                    mats = [functools.reduce(np.kron, [f[s] for f in part])
                            for s in range(len(coeffs))]
                    if j == 0:
                        mats = [m * c for m, c in zip(mats, coeffs)]
                    fused.append(as_tensor(np.stack(mats),
                                           self.id_coeff.device))
                facs = fused
            out.append((modes, facs))
        return out

    @property
    def dims(self):
        return self._dims

    @property
    def nDim(self):
        return len(self._dims)

    @property
    def nSum(self):
        return sum(getattr(self, f"g{gi}f0").shape[0]
                   for gi in range(len(self._modes))) + 1

    @property
    def shape(self):
        n = int(np.prod(self._dims))
        return (n, n)

    @property
    def dtype(self):
        return functools.reduce(
            torch.promote_types,
            [f.dtype for gi in range(len(self._modes))
             for f in self._stacks(gi)],
            self.id_coeff.dtype)

    @property
    def factors(self):
        """Full identity-padded stacked factors; the pure-identity
        coefficient becomes one extra term."""
        out = []
        groups = self.groups
        for d, n in enumerate(self._dims):
            eye = np.eye(n)
            mats = []
            for modes, facs in groups:
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

    def _plan(self):
        """The apply's steps (class docstring), from what the groups hold:
        ``self._steps`` and the buffers they read (``p<i>``)."""
        real = not self.dtype.is_complex
        device = self.id_coeff.device
        kernel, gemm, batched = [], [], []
        idc = float(self.id_coeff)
        for gi, modes in enumerate(self._modes):
            facs = self._stacks(gi)
            if gi in self._physical:
                dims = self._pdims
                pm = [d for m in modes for d in self._parts[m]]
                coeffs = getattr(self, f"g{gi}c").tolist()
            else:
                dims, pm, coeffs = self._dims, modes, [1.0] * len(facs[0])
            if gi not in self._physical and not (real and all(
                    f.shape[-1] <= SOP_MAX_WIDTH for f in facs)):
                if len(modes) == 1:
                    gemm.append((modes[0], facs[0].sum(dim=0)))
                else:
                    batched.append(gi)
                continue
            facs = [f.cpu() for f in facs]
            eyes = [torch.eye(f.shape[-1], dtype=f.dtype) for f in facs]
            terms = []
            for s, c in enumerate(coeffs):
                act = {d: f[s] for d, f, e in zip(pm, facs, eyes)
                       if not torch.equal(f[s], e)}
                if act:
                    terms.append((c, act))
                else:                      # c times the identity
                    idc += c
            if terms:
                kernel.append((dims, terms))
        self._budget = max((getattr(self, f"g{gi}f0").shape[0]
                            for gi in range(len(self._modes))), default=0)
        # In f64 the kernel groups on the same modes share a plan: a pair
        # launch or a fan-in serves the terms of all of them (1.0 ms less of
        # a 3-lane apply of the benchmark's CH3CN cut, PERF.md).  In f32
        # each keeps a plan of its own, summed into y in group order: the
        # f32 rounding of the JAX package's apply, which sharing would move
        # (tests/test_torch_graft_entry.py).
        if self.dtype == torch.float64:
            kernel = _share_plans(kernel, self._budget)
        names = itertools.count()

        def buffer(t):
            name = f"p{next(names)}"
            self.register_buffer(name, t.to(device).contiguous())
            return name

        def view(dims, mode):
            return (int(np.prod(dims[:mode])), int(np.prod(dims[mode + 1:])))

        def entry(dims, lc):
            if lc[0] == "pair":
                _, a, b, fa, fb, dsts = lc
                return ("pair", int(np.prod(dims[:a])),
                        int(np.prod(dims[a + 1:b])), int(np.prod(dims[b + 1:])),
                        buffer(torch.stack(fa)), buffer(torch.stack(fb)), dsts,
                        len(fa) > len(dsts))
            mode, facs, srcs, dsts = lc
            return ("mode", *view(dims, mode), buffer(torch.stack(facs)), srcs,
                    dsts)

        steps = []
        for k, (mode, F) in enumerate(gemm):
            if k == 0 and idc:
                F = F + idc * torch.eye(F.shape[0], dtype=F.dtype,
                                        device=F.device)
            steps.append(("gemm", *view(self._dims, mode), buffer(F), k > 0))
        for k, (dims, terms) in enumerate(kernel):
            if k == 0 and not gemm and idc:
                tally = collections.Counter(d for _, f in terms for d in f)
                d = min(tally, key=lambda d: (-tally[d], d))
                terms = terms + [(idc, {d: torch.eye(dims[d],
                                                     dtype=self.dtype)})]
            slots, plan = plan_terms(terms)
            steps.append(("kernel", slots, [entry(dims, lc) for lc in plan],
                          not gemm and k == 0))
        steps += [("batched", gi) for gi in batched]
        self._steps, self._id_first = steps, not (gemm or kernel)

    def _apply_lanes(self, X):
        """The planned apply to a lane stack X (m, n), real."""
        dt = torch.promote_types(self.dtype, X.dtype)
        X = X.to(dt).contiguous()
        m, n = X.shape
        Y = torch.empty_like(X)
        if self._id_first:
            torch.mul(X, self.id_coeff.to(dt), out=Y)
        for step in self._steps:
            if step[0] == "gemm":
                _, pre, post, name, accumulate = step
                _gemm_mode(getattr(self, name).to(dt), X, Y, pre, post,
                           accumulate)
                count("es.sop.gemm", calls=m)
            elif step[0] == "kernel":
                _, slots, plan, writes = step
                lanes = m if not slots else \
                    max(1, min(m, self._budget // slots))
                Z = X.new_empty((slots, lanes, n))
                for l0 in range(0, m, lanes):
                    k = min(lanes, m - l0)
                    Xc, Yc = X[l0:l0 + k], Y[l0:l0 + k]
                    first = writes
                    for lc in plan:
                        if lc[0] == "pair":
                            _, pre, mid, post, fa, fb, dsts, sums = lc
                            sop_pair(getattr(self, fa).to(dt),
                                     getattr(self, fb).to(dt), Xc,
                                     [Z[s, :k] for s in dsts], Yc, pre, mid,
                                     post, beta=not first)
                            first = first and not sums
                            continue
                        _, pre, post, name, srcs, dsts = lc
                        ins = [Xc if s is None else Z[s, :k] for s in srcs]
                        outs = [Yc] if dsts is None else \
                            [Z[s, :k] for s in dsts]
                        sop_contract(getattr(self, name).to(dt), ins, outs,
                                     pre, post, sum_out=dsts is None,
                                     beta=not (first and dsts is None))
                        first = first and dsts is not None
            else:
                modes, facs = self._modes[step[1]], self._stacks(step[1])
                for l in range(m):
                    Y[l] += _apply_terms(facs, modes, X[l].view(self._dims),
                                         self._dims).reshape(-1)
        return Y

    def matvec_lanes(self, X):
        """The apply to every lane of X (m, n) at once (see the class
        docstring); a complex stack as its real and imaginary lanes."""
        if X.is_complex() and not self.dtype.is_complex:
            m = X.shape[0]
            Y = self._apply_lanes(torch.cat([X.real, X.imag]))
            return torch.complex(Y[:m], Y[m:])
        return self._apply_lanes(X)

    def matvec(self, x):
        return self.matvec_lanes(x.reshape(1, -1)).reshape(x.shape)

    def diagonal(self):
        """Per group: the Kronecker product of the active-mode factor
        diagonals, broadcast over the inactive modes; identity terms add
        id_coeff."""
        out = torch.full((self.shape[0],), float(self.id_coeff),
                         dtype=self.dtype, device=self.id_coeff.device)
        for gi, modes in enumerate(self._modes):
            facs, coeffs, dims = self._stacks(gi), None, self._dims
            if gi in self._physical:
                coeffs, dims = getattr(self, f"g{gi}c"), self._pdims
                modes = [d for m in modes for d in self._parts[m]]
            shape = [dims[d] if d in modes else 1 for d in range(len(dims))]
            out = (out.view(dims) + _factor_diagonals(facs, coeffs)
                   .reshape(shape)).reshape(-1)
        return out

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


def fuse_parts(dims, target: int = 256):
    """The consecutive runs of modes that :func:`fuse_sop_terms` fuses:
    each run's dimension at most ``max(target, its largest mode)``."""
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
    return parts


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
    parts = fuse_parts(dims, target)
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
