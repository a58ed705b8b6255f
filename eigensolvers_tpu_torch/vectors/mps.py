"""MPSVector — matrix-product-state backend of the AbstractVector contract
(the JAX package's ``vectors/mps.py``, on torch tensors).

Fills the role of the reference's external TTNS backend
(reference: ttnsVector.py; the TTNS machinery itself is an external package,
SURVEY.md §2.2): a *compressible, inexact* state representation that
exercises the solver contract's compressed-backend seams —
``hasExactAddition=False`` (FEAST's two-solve quadrature path,
reference: feast.py:93-101), ``compress()``, bond-dimension telemetry
(``maxD`` → status KSmaxD/fitmaxD), and fit-accuracy checking.

Representation: open-boundary MPS with site tensors (D_{k-1}, n_k, D_k).
Operations are exact tensor arithmetic (direct-sum addition, zipper
contractions) followed by canonical SVD truncation to ``maxD``/``eps`` —
truncation is where the inexactness enters.  Shifted solves run in
compressed Krylov arithmetic (MINRES for Hermitian real shifts, BiCGStab
for complex shifts), each basis operation re-compressed.

Execution placement: every site tensor is a ``torch.Tensor`` on the
vector's device (default: the card; pass ``device="cpu"`` for the host), in
float64 or complex128.  Contractions are ``torch.tensordot``/``einsum``
(cuBLAS on the card), QR and SVD ``torch.linalg`` (cuSOLVER on the card;
the SVD takes the ``gesvd`` driver there, the full-accuracy QR-iteration
one, not the Jacobi default).  Shapes depend on the data: each truncation
reads the singular values of one bond to the host to choose its rank, and
each inner product returns a host scalar.  The JAX package keeps these
contractions on host numpy because XLA compiles every new shape; eager
PyTorch compiles nothing, so the port can run them on either device and
measures both (PERF.md, A.10).
"""

from __future__ import annotations

import functools
import math
from numbers import Number
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .abstract import AbstractVector, LINDEP_DEFAULT_VALUE
from ..config import normalize_options
from ..ops.operators import as_tensor, default_device

Array = torch.Tensor

_NP_OF = {torch.float32: np.float32, torch.float64: np.float64,
          torch.complex64: np.complex64, torch.complex128: np.complex128}

#: Device-to-host reads the tensor-network code makes because its control
#: flow depends on the data: "truncation" (the singular values of one bond,
#: to choose its rank), "scalar" (an inner product), "local" (a local
#: vector of a sweep's scipy solver, one each way per matvec).  The
#: counters count on every device; ``reset_host_reads`` zeroes them.
host_reads = {"truncation": 0, "scalar": 0, "local": 0}


def reset_host_reads():
    for k in host_reads:
        host_reads[k] = 0


# ----------------------------------------------------------------------------
# dtype / device / scalar helpers (shared with ttns.py and the sweeps)
# ----------------------------------------------------------------------------
def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype (``np.float64``,
    ``complex``, ...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


def numpy_dtype(dtype):
    """The numpy dtype of a torch dtype (host matrices of the solvers)."""
    return np.dtype(_NP_OF[dtype]) if isinstance(dtype, torch.dtype) \
        else np.dtype(dtype)


def result_type(*items) -> torch.dtype:
    """Promoted torch dtype of tensors and/or dtypes."""
    return functools.reduce(torch.promote_types,
                            [torch_dtype(getattr(i, "dtype", i))
                             for i in items])


def scalar(t):
    """A 0-d tensor (or number) as a host Python number."""
    if isinstance(t, torch.Tensor):
        host_reads["scalar"] += 1
    return t.item() if hasattr(t, "item") else t


def to_tensors(tensors, device=None, dtype=None) -> List[Array]:
    """Site tensors as torch tensors: numpy arrays go to ``device``
    (default: the card, see ``default_device``); tensors stay where they
    are unless ``device`` is given."""
    return [as_tensor(t, device, dtype=None if dtype is None
                      else torch_dtype(dtype)) for t in tensors]


def svd(mat: Array):
    """Thin SVD; on CUDA with cuSOLVER's ``gesvd`` (full accuracy)."""
    return torch.linalg.svd(mat, full_matrices=False,
                            driver="gesvd" if mat.is_cuda else None)


def keep_count(s: Array, maxD: Optional[int], eps: float):
    """Rank kept by a truncation from the singular values ``s`` (one
    device-to-host read), and the host copy of ``s**2``."""
    host_reads["truncation"] += 1
    s2 = (s.abs() ** 2).cpu().numpy()
    keep = len(s2)
    if eps > 0.0:
        tot = np.sum(s2)
        if tot > 0:
            csum = np.cumsum(s2[::-1])[::-1]
            keep = max(1, int(np.sum(csum > eps ** 2 * tot)))
    if maxD is not None:
        keep = min(keep, maxD)
    return keep, s2


def _rel_keep(s: Array, eps: float) -> int:
    """Operator-compression rank: singular values above ``eps`` relative
    (in the mean-square sense of the JAX package's MPO compression)."""
    s2 = (s.abs() ** 2).cpu().numpy()
    tot = np.sum(s2)
    return max(1, int(np.sum(s2 > (eps ** 2) * tot / max(len(s2), 1))))


def operator_factors(op) -> List[Array]:
    """An operator's stacked (S, n, n) factors as tensors on their device
    (the port's operators hold tensors; numpy factors go to the card)."""
    return to_tensors(op.factors)


# ----------------------------------------------------------------------------
# core MPS tensor algebra
# ----------------------------------------------------------------------------
def mps_random(dims: Sequence[int], maxD: int, seed: int = 0,
               dtype=np.float64, device=None) -> List[Array]:
    """Random MPS with bond dims capped by maxD and the entanglement limit
    (numpy ``RandomState(seed)`` draws, the JAX package's numbers, placed on
    ``device``, default the card)."""
    rng = np.random.RandomState(seed)
    L = len(dims)
    bonds = [1]
    for k in range(1, L):
        bonds.append(int(min(maxD, math.prod(dims[:k]), math.prod(dims[k:]))))
    bonds.append(1)
    ts = []
    for k in range(L):
        t = rng.standard_normal((bonds[k], dims[k], bonds[k + 1]))
        if np.issubdtype(np.dtype(dtype), np.complexfloating):
            t = t + 1j * rng.standard_normal(t.shape)
        ts.append(t.astype(dtype))
    return to_tensors(ts, default_device(device))


def mps_vdot(bra: List[Array], ket: List[Array]):
    """<bra|ket> via left-to-right transfer (zipper) contraction; a host
    scalar."""
    E = torch.ones((1, 1), dtype=result_type(*bra, *ket),
                   device=bra[0].device)
    for A, B in zip(bra, ket):
        # E_{a,b} A*_{a,n,a'} B_{b,n,b'} -> E'_{a',b'}
        T = torch.tensordot(E, A.to(E.dtype).conj(), dims=([0], [0]))
        E = torch.tensordot(T, B.to(E.dtype), dims=([0, 1], [0, 1]))
    return scalar(E[0, 0])


def mps_scale(ts: List[Array], c) -> List[Array]:
    """c times the state: the first tensor scaled, every tensor cast to the
    promoted dtype (a complex c makes the whole state complex; torch
    contractions take one dtype)."""
    first = ts[0] * scalar(c)
    return [first] + [t.to(first.dtype) for t in ts[1:]]


def mps_add(a: List[Array], b: List[Array]) -> List[Array]:
    """Exact direct-sum addition."""
    L = len(a)
    dtype = result_type(a[0], b[0])
    if L == 1:
        return [a[0].to(dtype) + b[0].to(dtype)]
    out = []
    for k in range(L):
        Ak, Bk = a[k].to(dtype), b[k].to(dtype)
        if k == 0:
            t = torch.cat([Ak, Bk], dim=2)
        elif k == L - 1:
            t = torch.cat([Ak, Bk], dim=0)
        else:
            Dl = Ak.shape[0] + Bk.shape[0]
            Dr = Ak.shape[2] + Bk.shape[2]
            t = Ak.new_zeros((Dl, Ak.shape[1], Dr))
            t[:Ak.shape[0], :, :Ak.shape[2]] = Ak
            t[Ak.shape[0]:, :, Ak.shape[2]:] = Bk
        out.append(t)
    return out


def mps_compress(ts: List[Array], maxD: Optional[int] = None,
                 eps: float = 0.0) -> Tuple[List[Array], float]:
    """Canonicalize (left QR sweep) then truncate (right-to-left SVD sweep).

    :returns: (compressed tensors, discarded weight estimate)
    """
    L = len(ts)
    ts = list(ts)
    # left-to-right QR: bring to left-canonical form
    for k in range(L - 1):
        Dl, n, Dr = ts[k].shape
        q, r = torch.linalg.qr(ts[k].reshape(Dl * n, Dr))
        ts[k] = q.reshape(Dl, n, q.shape[1])
        ts[k + 1] = torch.tensordot(r, ts[k + 1], dims=([1], [0]))
    # right-to-left SVD truncation
    discarded = 0.0
    for k in range(L - 1, 0, -1):
        Dl, n, Dr = ts[k].shape
        u, s, vh = svd(ts[k].reshape(Dl, n * Dr))
        keep, s2 = keep_count(s, maxD, eps)
        discarded += float(np.sum(s2[keep:]))
        u, s, vh = u[:, :keep], s[:keep], vh[:keep]
        ts[k] = vh.reshape(keep, n, Dr)
        carry = u * s.to(u.dtype)
        ts[k - 1] = torch.tensordot(ts[k - 1], carry, dims=([2], [0]))
    return ts, discarded


def mps_dense(ts: List[Array]) -> Array:
    """Densify to the full tensor (small test systems only)."""
    out = ts[0]
    for t in ts[1:]:
        out = torch.tensordot(out, t, dims=([out.ndim - 1], [0]))
    return out[0, ..., 0]


def mps_from_dense(x, dims: Sequence[int], maxD: Optional[int] = None,
                   eps: float = 0.0, device=None) -> List[Array]:
    """Exact (up to truncation) MPS decomposition of a dense tensor (numpy
    input goes to ``device``, default the card)."""
    x = as_tensor(x, device).reshape(tuple(dims))
    L = len(dims)
    ts = []
    carry = x.reshape(1, -1)
    Dl = 1
    for k in range(L - 1):
        mat = carry.reshape(Dl * dims[k], -1)
        u, s, vh = svd(mat)
        keep, _ = keep_count(s, maxD, eps)
        u, s, vh = u[:, :keep], s[:keep], vh[:keep]
        ts.append(u.reshape(Dl, dims[k], keep))
        carry = s.to(vh.dtype)[:, None] * vh
        Dl = keep
    ts.append(carry.reshape(Dl, dims[-1], 1))
    return ts


# ----------------------------------------------------------------------------
# MPO (sum-of-products → matrix product operator)
# ----------------------------------------------------------------------------
class MPO:
    """Matrix product operator with site tensors (W_{k-1}, n_k, n_k, W_k),
    on the device of the operator's factors.

    Built from a sum-of-products operator with bond dimension nSum
    (term-diagonal construction); ``compress()`` reduces the bond via SVD.
    """

    def __init__(self, tensors: List[Array]):
        self.tensors = to_tensors(tensors)

    @classmethod
    def from_sop(cls, op) -> "MPO":
        factors = operator_factors(op)
        L = len(factors)
        ts = []
        for k, F in enumerate(factors):
            if L == 1:
                t = F.sum(dim=0)[None, :, :, None]
            elif k == 0:
                t = F.permute(1, 2, 0)[None]                    # (1,n,n,S)
            elif k == L - 1:
                t = F[..., None]                                # (S,n,n,1)
            else:                                # term index on the diagonal
                t = torch.diag_embed(F.permute(1, 2, 0)).permute(2, 0, 1, 3)
            ts.append(t)
        return cls(ts)

    @property
    def dims(self):
        return [t.shape[1] for t in self.tensors]

    @property
    def dtype(self):
        return result_type(*self.tensors)

    @classmethod
    def from_sop_compressed(cls, op, eps: float = 1e-12) -> "MPO":
        """Build a bond-compressed MPO directly from stacked SoP factors
        without materializing the term-diagonal middle tensors (whose
        (S, n, n, S) form is prohibitive for production term counts).

        Left-to-right construction: carry a (bond, S) term-mixing matrix,
        absorb the next mode's stacked factors, SVD-truncate the
        ((bond, n, n), S) matricization; finish with a right-to-left
        lossless compression pass.
        """
        factors = operator_factors(op)
        S = factors[0].shape[0]
        L = len(factors)
        C = factors[0].new_ones((1, S))
        tensors = []
        for k, F in enumerate(factors):
            n = F.shape[1]
            if k == L - 1:
                tensors.append(torch.einsum("as,sij->aij", C, F)[..., None])
                break
            T = torch.einsum("as,sij->aijs", C, F)
            kl = T.shape[0]
            u, sv, vh = svd(T.reshape(kl * n * n, S))
            keep = _rel_keep(sv, eps)
            tensors.append(u[:, :keep].reshape(kl, n, n, keep))
            C = sv[:keep, None].to(vh.dtype) * vh[:keep]
        return cls(tensors).compress(eps=eps)

    def compress(self, eps: float = 1e-13) -> "MPO":
        """SVD-compress the MPO bond dimensions (lossless at eps≈1e-13),
        left-to-right then right-to-left: only together do the bonds reach
        the operator Schmidt ranks."""
        ts = list(self.tensors)
        L = len(ts)

        def _trunc(mat):
            u, s, vh = svd(mat)
            keep = _rel_keep(s, eps)
            return u[:, :keep], s[:keep].to(u.dtype), vh[:keep]

        for k in range(L - 1):   # left → right
            W1, n, m, W2 = ts[k].shape
            u, s, vh = _trunc(ts[k].reshape(W1 * n * m, W2))
            ts[k] = u.reshape(W1, n, m, u.shape[1])
            ts[k + 1] = torch.tensordot(s[:, None] * vh, ts[k + 1],
                                        dims=([1], [0]))
        for k in range(L - 1, 0, -1):   # right → left
            W1, n, m, W2 = ts[k].shape
            u, s, vh = _trunc(ts[k].reshape(W1, n * m * W2))
            ts[k] = vh.reshape(vh.shape[0], n, m, W2)
            ts[k - 1] = torch.tensordot(ts[k - 1], u * s[None, :],
                                        dims=([3], [0]))
        return MPO(ts)

    def apply(self, mps: List[Array]) -> List[Array]:
        """Exact MPO @ MPS (bond dims multiply; compress afterwards)."""
        out = []
        for W, T in zip(self.tensors, mps):
            dtype = result_type(W, T)
            # W_{w,i,j,w'} T_{a,j,b} -> (w a, i, w' b)
            t = torch.tensordot(W.to(dtype), T.to(dtype), dims=([2], [1]))
            t = t.permute(0, 3, 1, 2, 4)                  # (w, a, i, w', b)
            w, a, i, w2, b = t.shape
            out.append(t.reshape(w * a, i, w2 * b))
        return out

    def sandwich(self, bra: List[Array], ket: List[Array]):
        """<bra| MPO |ket> zipper contraction (host scalar)."""
        dtype = result_type(bra[0], self.dtype, ket[0])
        E = torch.ones((1, 1, 1), dtype=dtype, device=bra[0].device)
        for A, W, B in zip(bra, self.tensors, ket):
            # E_{a,w,b} A*_{a,i,a'} W_{w,i,j,w'} B_{b,j,b'}
            T = torch.tensordot(E, A.to(dtype).conj(), dims=([0], [0]))
            T = torch.tensordot(T, W.to(dtype), dims=([0, 2], [0, 1]))
            E = torch.tensordot(T, B.to(dtype), dims=([0, 2], [0, 1]))
        return scalar(E[0, 0, 0])


def _as_mpo(operator, eps=None) -> MPO:
    """Coerce to a bond-COMPRESSED MPO, cached on the operator object
    (keyed by the compression cutoff ``eps``; None = class default).

    The term-diagonal construction has bond = nSum while the operator's
    Schmidt rank after lossless compression is typically O(10); every
    sandwich/apply costs between linearly and quadratically in that bond,
    so compressing once and caching is the dominant MPS-path
    optimization."""
    if isinstance(operator, MPO):
        return operator
    cache = getattr(operator, "_mpo_cache", None)
    if not isinstance(cache, dict):
        cache = {}
        try:
            operator._mpo_cache = cache
        except Exception:  # pragma: no cover - exotic operator types
            pass
    mpo = cache.get(eps)
    if mpo is None:
        kw = {} if eps is None else {"eps": float(eps)}
        mpo = MPO.from_sop_compressed(operator, **kw)
        cache[eps] = mpo
    return mpo


# ----------------------------------------------------------------------------
# the backend class
# ----------------------------------------------------------------------------
class MPSVector(AbstractVector):
    """Matrix-product-state vector.  Numpy site tensors go to ``device``
    (default: the card, which must exist; pass ``device="cpu"`` for the
    host); torch tensors stay where they are unless ``device`` is given.

    ``options`` (same scoping idea as reference ttnsVector.py:18-44):
      * ``compressArgs``: {"maxD": int, "eps": float} — truncation targets
      * ``linearSystemArgs``: {"linearSolver": "minres"|"bicgstab",
        "linearIter", "linear_tol", "maxD"} — compressed-Krylov solve;
        ``"method": "als"`` solves by ALS sweeps instead; a ``"report"``
        dict there counts the solves under "solves"
      * ``orthogonalizationArgs``/``stateFittingArgs``: {"maxD", "eps"}
        overriding compressArgs for those tasks
    """

    def __init__(self, tensors: List[Array], options: Optional[dict] = None,
                 device=None):
        self.tensors = to_tensors(tensors, device)
        options = normalize_options(options)
        comp = dict(options.get("compressArgs", {}))
        comp.setdefault("maxD", 64)
        comp.setdefault("eps", 1e-10)
        options["compressArgs"] = comp
        lin = dict(options.get("linearSystemArgs", {}))
        lin.setdefault("linearSolver", "minres")
        lin.setdefault("linearIter", 200)
        lin.setdefault("linear_tol", 1e-3)
        lin.setdefault("maxD", comp["maxD"])
        lin.setdefault("eps", comp["eps"])
        options["linearSystemArgs"] = lin
        options.setdefault("orthogonalizationArgs", dict(comp))
        options.setdefault("stateFittingArgs", dict(comp))
        self.options = options

    # -- tensor-network algebra hooks ----------------------------------------
    # Everything below the raw tensor level is representation-agnostic: the
    # tree backend (vectors/ttns.py) overrides exactly these hooks and
    # inherits every contract method, including the compressed-Krylov
    # solvers.
    def _wrap(self, tensors) -> "MPSVector":
        """New vector of this backend around raw tensors (options shared by
        reference, like the reference's option plumbing ttnsVector.py:114-117)."""
        return type(self)(tensors, self.options)

    def _vdot_t(self, a: List[Array], b: List[Array]):
        return mps_vdot(a, b)

    def _add_t(self, a: List[Array], b: List[Array]) -> List[Array]:
        return mps_add(a, b)

    def _scale_t(self, ts: List[Array], c) -> List[Array]:
        return mps_scale(ts, c)

    def _compress_t(self, ts: List[Array], maxD=None, eps=0.0):
        return mps_compress(ts, maxD=maxD, eps=eps)

    def _mpo(self, operator):
        # compressArgs["operatorEps"] overrides the operator-compression
        # cutoff (None/absent = class default, near-lossless 1e-12)
        return _as_mpo(operator,
                       eps=self.options.get("compressArgs", {})
                       .get("operatorEps"))

    def _als_solve_t(self, mpo, bt, sigma, x0t, sign, **kw):
        """Two-site ALS sweep solve in raw-tensor space (chain engine;
        the tree backend overrides with the tree engine)."""
        from .mps_sweeps import als_solve
        return als_solve(mpo.tensors, bt, sigma, x0=x0t, sign=sign, **kw)

    _supports_als = True   # DMRG/ALS sweep engines available

    # -- constructors -------------------------------------------------------
    @classmethod
    def random(cls, dims, maxD, options=None, seed=0, dtype=np.float64,
               device=None):
        v = cls(mps_random(dims, maxD, seed=seed, dtype=dtype,
                           device=device), options)
        return v.normalize()

    @classmethod
    def from_dense(cls, x, dims, options=None, maxD=None, eps=0.0,
                   device=None):
        return cls(mps_from_dense(x, dims, maxD=maxD, eps=eps,
                                  device=device), options)

    def to_dense(self) -> np.ndarray:
        return mps_dense(self.tensors).cpu().numpy()

    # -- properties ---------------------------------------------------------
    @property
    def hasExactAddition(self) -> bool:
        return False

    @property
    def dtype(self) -> torch.dtype:
        return result_type(*self.tensors)

    @property
    def maxD(self) -> int:
        return max(t.shape[0] for t in self.tensors[1:]) \
            if len(self.tensors) > 1 else 1

    @property
    def dims(self):
        return [t.shape[1] for t in self.tensors]

    def __len__(self) -> int:
        return int(math.prod(self.dims))

    # -- scalar ops ---------------------------------------------------------
    def __mul__(self, other: Number):
        return self._wrap(self._scale_t(self.tensors, other))

    __rmul__ = __mul__

    def __truediv__(self, other: Number):
        return self._wrap(self._scale_t(self.tensors, 1.0 / other))

    def __imul__(self, other: Number):
        self.tensors = self._scale_t(self.tensors, other)
        return self

    def __itruediv__(self, other: Number):
        self.tensors = self._scale_t(self.tensors, 1.0 / scalar(other))
        return self

    def norm(self) -> float:
        return float(np.sqrt(abs(self._vdot_t(self.tensors, self.tensors))))

    def normalize(self):
        n = self.norm()
        if n > 0:
            self.tensors[0] = self.tensors[0] / n
        return self

    def real(self):
        # direct-sum of (v + v*)/2 then compress would double bonds; the
        # FEAST accumulation path only calls real() on exact-addition
        # backends, so plain elementwise real of an (already combined)
        # state is the meaningful operation here.
        return self._wrap([torch.real(t) for t in self.tensors])

    def conjugate(self):
        return self._wrap([t.conj().resolve_conj() for t in self.tensors])

    def vdot(self, other, conjugate: bool = True):
        if not conjugate:
            bra = [t.conj() for t in self.tensors]
            return self._vdot_t(bra, other.tensors)
        return self._vdot_t(self.tensors, other.tensors)

    def copy(self):
        return self._wrap([t.clone() for t in self.tensors])

    def applyOp(self, operator):
        mpo = self._mpo(operator)
        args = self.options["compressArgs"]
        ts, _ = self._compress_t(mpo.apply(self.tensors),
                                 maxD=args["maxD"], eps=args["eps"])
        return self._wrap(ts)

    def compress(self):
        args = self.options["compressArgs"]
        ts, _ = self._compress_t(self.tensors, maxD=args["maxD"],
                                 eps=args["eps"])
        return self._wrap(ts)

    def to_state_dict(self) -> dict:
        state = {"kind": np.asarray("mps"),
                 "n_sites": np.asarray(len(self.tensors))}
        for i, t in enumerate(self.tensors):
            state[f"tensor_{i}"] = t.detach().resolve_conj().cpu().numpy()
        return state

    @classmethod
    def from_state_dict(cls, state, options=None, device=None):
        n = int(state["n_sites"])
        return cls([np.asarray(state[f"tensor_{i}"]) for i in range(n)],
                   options, device=device)

    # -- collective ops -----------------------------------------------------
    @classmethod
    def linearCombination(cls, vectors: List["MPSVector"], coeffs):
        """Σ c_i v_i by direct-sum accumulation with intermediate
        compression (bounds the working bond dimension)."""
        assert len(vectors) == len(coeffs)
        v0 = vectors[0]
        args = v0.options.get("stateFittingArgs", v0.options["compressArgs"])
        maxD, eps = args["maxD"], args.get("eps", 0.0)
        acc = v0._scale_t(v0.tensors, coeffs[0])
        for v, c in zip(vectors[1:], coeffs[1:]):
            acc = v0._add_t(acc, v0._scale_t(v.tensors, c))
            if max(t.shape[0] for t in acc[1:]) > 2 * maxD:
                acc, _ = v0._compress_t(acc, maxD=maxD, eps=eps)
        acc, _ = v0._compress_t(acc, maxD=maxD, eps=eps)
        return v0._wrap(acc)

    @classmethod
    def orthogonalize_against_set(cls, x: "MPSVector", qs: List["MPSVector"],
                                  lindep=LINDEP_DEFAULT_VALUE):
        """MGS with compression after each projection subtraction."""
        args = x.options.get("orthogonalizationArgs",
                             x.options["compressArgs"])
        maxD, eps = args["maxD"], args.get("eps", 0.0)
        cur = list(x.tensors)
        for q in qs:
            c = x._vdot_t(q.tensors, cur)
            cur = x._add_t(cur, x._scale_t(q.tensors, -c))
            cur, _ = x._compress_t(cur, maxD=maxD, eps=eps)
        nrm2 = abs(x._vdot_t(cur, cur))
        if nrm2 < lindep:
            return None
        cur = x._scale_t(cur, 1.0 / np.sqrt(nrm2))
        return x._wrap(cur)

    @classmethod
    def orthogonalize(cls, xs: List["MPSVector"],
                      lindep=LINDEP_DEFAULT_VALUE):
        """Whole-set orthonormalization (contract method,
        reference: abstractVector.py:112, ttnsVector.py:151): sequential
        compressed Gram-Schmidt — each vector orthogonalized against the
        already-kept set, dropped on linear dependence."""
        out: List["MPSVector"] = []
        for x in xs:
            if not out:
                nrm2 = abs(x._vdot_t(x.tensors, x.tensors))
                if nrm2 > lindep:
                    out.append(x._wrap(
                        x._scale_t(x.tensors, 1.0 / np.sqrt(nrm2))))
                continue
            v = cls.orthogonalize_against_set(x, out, lindep)
            if v is not None:
                out.append(v)
        return out

    @classmethod
    def matrixRepresentation(cls, operator, vectors: List["MPSVector"]):
        """Hermitian m x m subspace matrix (host numpy).  Per COLUMN j the
        operator is applied once (K_j = H|v_j>, uncompressed) and the
        column filled with plain overlaps <v_i|K_j>."""
        v0 = vectors[0]
        mpo = v0._mpo(operator)
        m = len(vectors)
        M = np.empty((m, m), dtype=numpy_dtype(result_type(
            mpo.dtype, *[v.dtype for v in vectors])))
        for j in range(m):
            K = mpo.apply(vectors[j].tensors)
            for i in range(j + 1):
                val = v0._vdot_t(vectors[i].tensors, K)
                M[i, j] = val
                M[j, i] = np.conj(val)
        return M

    @classmethod
    def overlapMatrix(cls, vectors: List["MPSVector"]):
        m = len(vectors)
        v0 = vectors[0]
        S = np.empty((m, m), dtype=numpy_dtype(result_type(
            *[v.dtype for v in vectors])))
        for i in range(m):
            for j in range(i, m):
                S[i, j] = v0._vdot_t(vectors[i].tensors, vectors[j].tensors)
                S[j, i] = np.conj(S[i, j])
        return S

    @classmethod
    def extendMatrixRepresentation(cls, operator, vectors, opMat):
        """O(m) incremental extension: ONE operator application for the new
        column's shared ket, then m overlaps (reference contract
        numpyVector.py:205-221 at the compressed-backend level)."""
        v0 = vectors[0]
        mpo = v0._mpo(operator)
        K = mpo.apply(vectors[-1].tensors)
        col = np.array([v0._vdot_t(v.tensors, K) for v in vectors])
        opMat = np.append(opMat, col[None, :-1].conj(), axis=0)
        opMat = np.append(opMat, col[:, None], axis=1)
        return opMat

    @classmethod
    def extendOverlapMatrix(cls, vectors, overlap):
        v0 = vectors[0]
        col = np.array([v0._vdot_t(v.tensors, vectors[-1].tensors)
                        for v in vectors])
        overlap = np.append(overlap, col[None, :-1].conj(), axis=0)
        overlap = np.append(overlap, col[:, None], axis=1)
        return overlap

    # -- compressed-Krylov shifted solve ------------------------------------
    @classmethod
    def solve(cls, H, b: "MPSVector", sigma, x0=None, opType="her",
              reverseGF=False):
        """(sigma - H) x = b in compressed MPS arithmetic.

        MINRES for Hermitian (real sigma), BiCGStab for complex shifts;
        every vector operation is followed by truncation to the solve's
        ``maxD`` — the compressed-arithmetic analog of the reference's
        inexact sweep solves (reference: ttnsVector.py:169-196).  With
        ``linearSystemArgs["method"] == "als"`` the two-site ALS sweep
        engine solves instead.
        """
        mpo = b._mpo(H)
        opts = b.options["linearSystemArgs"]
        maxD, eps = opts["maxD"], opts.get("eps", 0.0)
        rtol = opts["linear_tol"]
        maxiter = opts["linearIter"]
        sign = -1.0 if reverseGF else 1.0
        sigma = scalar(sigma)
        complex_shift = bool(np.iscomplexobj(np.asarray(sigma)))

        report = opts.get("report")
        if report is not None:
            report["solves"] = report.get("solves", 0) + 1
        if opts.get("method", "krylov") == "als":
            # DMRG-style two-site sweeps (the reference's LinearSystem-sweep
            # analog, ttnsVector.py:169-196) with SVD bond adaptation;
            # dispatched through the backend hook so chains use the chain
            # engine and trees the tree engine (ttns_sweeps.py)
            x0t = b.tensors if x0 is None else x0.tensors
            xt = b._als_solve_t(
                mpo, b.tensors, sigma, x0t, sign,
                maxD=maxD, eps=eps,
                nSweep=opts.get("nSweep", 20),
                convTol=opts.get("convTol", rtol),
                local_tol=opts.get("siteTol", max(rtol * 1e-2, 1e-10)),
                local_maxiter=maxiter)
            return b._wrap(xt)

        def comp(ts):
            out, _ = b._compress_t(ts, maxD=maxD, eps=eps)
            return out

        def matvec(ts):
            Hts = mpo.apply(ts)
            out = b._add_t(b._scale_t(ts, sign * sigma),
                           b._scale_t(Hts, -sign))
            return comp(out)

        bt = b.tensors
        if complex_shift and not bt[0].is_complex():
            bt = [t.to(torch.complex128) for t in bt]
        bnorm = float(np.sqrt(abs(b._vdot_t(bt, bt))))
        tol_abs = max(rtol * bnorm, 0.0)

        solver = "bicgstab" if (complex_shift or opType == "gen") else "minres"
        if solver == "minres":
            x = _tn_minres(b, matvec, bt, comp, tol_abs, maxiter)
        else:
            x = _tn_bicgstab(b, matvec, bt, comp, tol_abs, maxiter)
        return b._wrap(x)


def _tn_minres(ops, matvec, b, comp, tol_abs, maxiter):
    """MINRES in compressed tensor-network arithmetic (Paige-Saunders
    recurrences with re-compression after every vector update).  ``ops`` is
    any vector instance providing the _add_t/_scale_t/_vdot_t hooks (MPS or
    tree backend)."""
    x = ops._scale_t(b, 0.0)
    r1 = b
    y = r1
    beta1 = np.sqrt(abs(ops._vdot_t(r1, y)))
    if beta1 == 0:
        return x
    oldb, beta = 0.0, beta1
    dbar = epsln = 0.0
    phibar = beta1
    cs, sn = -1.0, 0.0
    w = ops._scale_t(b, 0.0)
    w2 = ops._scale_t(b, 0.0)
    r2 = r1
    for itn in range(1, maxiter + 1):
        v = ops._scale_t(y, 1.0 / beta)
        y = matvec(v)
        if itn >= 2:
            y = comp(ops._add_t(y, ops._scale_t(r1, -beta / oldb)))
        alfa = np.real(ops._vdot_t(v, y))
        y = comp(ops._add_t(y, ops._scale_t(r2, -alfa / beta)))
        r1, r2 = r2, y
        oldb, beta = beta, np.sqrt(abs(ops._vdot_t(y, y)))
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        gamma = max(np.sqrt(gbar * gbar + beta * beta), 1e-300)
        cs, sn = gbar / gamma, beta / gamma
        phi = cs * phibar
        phibar = sn * phibar
        w1 = w2
        w2 = w
        w = comp(ops._add_t(ops._add_t(v, ops._scale_t(w1, -oldeps)),
                            ops._scale_t(w2, -delta)))
        w = ops._scale_t(w, 1.0 / gamma)
        x = comp(ops._add_t(x, ops._scale_t(w, phi)))
        if phibar <= tol_abs or beta == 0:
            break
    return x


def _tn_bicgstab(ops, matvec, b, comp, tol_abs, maxiter):
    """BiCGStab in compressed tensor-network arithmetic (complex shifts)."""
    x = ops._scale_t(b, 0.0)
    r = b
    rhat = list(r)
    rho = alpha = omega = 1.0
    v = p = None
    rho_prev = None
    for itn in range(1, maxiter + 1):
        rho = ops._vdot_t(rhat, r)
        if rho == 0:
            break
        if itn == 1:
            p = r
        else:
            beta = (rho / rho_prev) * (alpha / omega)
            pm = ops._add_t(p, ops._scale_t(v, -omega))
            p = comp(ops._add_t(r, ops._scale_t(pm, beta)))
        v = matvec(p)
        denom = ops._vdot_t(rhat, v)
        if denom == 0:
            break
        alpha = rho / denom
        s = comp(ops._add_t(r, ops._scale_t(v, -alpha)))
        snorm = np.sqrt(abs(ops._vdot_t(s, s)))
        if snorm <= tol_abs:
            x = comp(ops._add_t(x, ops._scale_t(p, alpha)))
            break
        t = matvec(s)
        tt = ops._vdot_t(t, t)
        if tt == 0:
            break
        omega = ops._vdot_t(t, s) / tt
        x = comp(ops._add_t(ops._add_t(x, ops._scale_t(p, alpha)),
                            ops._scale_t(s, omega)))
        r = comp(ops._add_t(s, ops._scale_t(t, -omega)))
        rnorm = np.sqrt(abs(ops._vdot_t(r, r)))
        if rnorm <= tol_abs:
            break
        rho_prev = rho
    return x
