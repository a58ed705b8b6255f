"""ShardedVector — the mesh-sharded backend of the AbstractVector contract.

Counterpart of ``eigensolvers_tpu/parallel/sharded.py``.  There the state
is one ``jax.Array`` pinned to a ``NamedSharding`` and GSPMD partitions
the inherited ``JaxVector`` programs.  Here each rank holds its block of
the state's rows (its first axis split over the mesh's "x" group) as a
plain tensor, and the inherited :class:`~eigensolvers_tpu_torch.vectors.
dense.TorchVector` code runs on those blocks through its hooks: every
contraction over the state axis is one all-reduce over "x", every
operator apply one all-gather of x over "x" followed by the rank's local
row-block product (:class:`RowShardedOperator`), the tall QR of a stacked
basis one all-gather of the R factors (TSQR), and a batched solve splits
its lanes over "b" and gathers them once after it.

1-D states of any length are zero-padded up to a multiple of the "x"
extent, with operators zero-embedded to match
(:class:`~eigensolvers_tpu_torch.ops.operators.PaddedOperator`);
multi-axis states must have their first axis divisible by it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import linear_solvers as ls
from ..ops.operators import (AbstractOperator, DenseOperator,
                             PaddedOperator, as_operator, as_tensor,
                             require_true_fp32)
from ..ops.sparse import BSROperator
from ..vectors.dense import TorchVector
from .mesh import Mesh, make_mesh


def _rows(n: int, mesh: Mesh) -> slice:
    """This rank's block of ``n`` rows over "x" (n divisible by x)."""
    per = n // mesh.shape["x"]
    return slice(mesh.rank["x"] * per, (mesh.rank["x"] + 1) * per)


class ShardedVector(TorchVector):
    """A TorchVector whose ``array`` is this rank's block of rows of the
    state, over the "x" group of ``mesh``.

    The constructor takes the WHOLE state (numpy or tensor; every rank
    passes the same) and keeps this rank's rows on the mesh's device; a
    vector made from an existing one (:meth:`_like`) takes rows as they
    are.  ``mesh`` defaults to :meth:`set_default_mesh`'s, else a mesh of
    every rank on ``device`` (the card by default; :func:`~.mesh.make_mesh`),
    built once and kept as the default.  A stack of such
    vectors (``_stack``) is the (m, n/x) stack of this rank's rows, so
    S = V V^H is a local product and one all-reduce over "x"."""

    #: mesh used when none is passed explicitly (set via ``set_default_mesh``)
    _default_mesh: Optional[Mesh] = None

    def __init__(self, array, options: Optional[dict] = None,
                 mesh: Optional[Mesh] = None, device=None):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(
                f"mesh must be an eigensolvers_tpu_torch.parallel Mesh, got "
                f"{type(mesh).__name__} — note from_array(array, mesh=..., "
                f"options=...) takes the mesh BEFORE the options dict")
        if mesh is None:
            if ShardedVector._default_mesh is None:
                ShardedVector._default_mesh = make_mesh(device=device)
            mesh = ShardedVector._default_mesh
        arr = as_tensor(array, mesh.device)
        xdim = mesh.shape["x"]
        if arr.shape[0] % xdim != 0:
            if arr.ndim != 1:
                raise ValueError(
                    f"first axis {arr.shape[0]} not divisible by mesh "
                    f"x={xdim}; multi-axis states cannot be zero-padded "
                    f"(flatten first, or choose a compatible mesh)")
            # transparent zero padding: it adds 0 to every dot and norm,
            # and _as_operator zero-embeds the operator to match
            arr = torch.nn.functional.pad(arr, (0, (-arr.shape[0]) % xdim))
        super().__init__(arr[_rows(arr.shape[0], mesh)].contiguous(),
                         options)
        self.mesh = mesh

    @classmethod
    def _local(cls, block, options, mesh: Mesh) -> "ShardedVector":
        """The vector whose rows on this rank are ``block``."""
        self = cls.__new__(cls)
        TorchVector.__init__(self, block, options)
        self.mesh = mesh
        return self

    # -- backend hooks --------------------------------------------------------
    def _like(self, array, options=None) -> "ShardedVector":
        return ShardedVector._local(
            array, self.options if options is None else options, self.mesh)

    @classmethod
    def _reducer(cls, ref):
        return ref.mesh.allreduce_x

    @classmethod
    def _tall_qr(cls, A, ref):
        """TSQR of the row-sharded (n, m) stack: the local QR of this
        rank's rows, one all-gather of every rank's R, the QR of their
        stack, and this rank's rows of Q.  With one "x" rank the second QR
        is of a triangular matrix, which leaves it (Q2 = I) as it is."""
        mesh = ref.mesh
        m = A.shape[1]
        if A.shape[0] < m:
            raise ValueError(f"TSQR needs at least {m} rows a rank, this "
                             f"one holds {A.shape[0]}")
        Q1, R1 = torch.linalg.qr(A, mode="reduced")
        Q2, R = torch.linalg.qr(mesh.allgather_x(R1, dim=0), mode="reduced")
        k = mesh.rank["x"]
        return Q1 @ Q2[k * m:(k + 1) * m], R

    @classmethod
    def _batched(cls, solve, op, B, sigmas, X0, ref):
        return solve_lanes(ref.mesh, solve, op, B, sigmas, X0)

    @classmethod
    def _batch_lane_pad(cls, nlanes: int, ref) -> int:
        """Lanes must divide the "b" extent to split evenly over it."""
        return (-nlanes) % ref.mesh.shape["b"]

    @classmethod
    def _place_batch(cls, B, ref, state_axis: int = 1):
        """This rank's lanes of a stacked (nlanes, ...) solve batch: lanes
        split over "b" (FEAST quadrature x subspace lanes, block-Lanczos
        seeds); the state axis is this rank's rows already."""
        return B[ls._lane_block(B.shape[0], ref.mesh)]

    # -- the contract ---------------------------------------------------------
    @property
    def size(self) -> int:
        return self.array.numel() * self.mesh.shape["x"]

    @property
    def shape(self):
        return (self.array.shape[0] * self.mesh.shape["x"],) \
            + tuple(self.array.shape[1:])

    def __len__(self) -> int:
        return self.size

    @property
    def rows(self) -> slice:
        """This rank's rows of the whole (padded) state."""
        return _rows(self.size, self.mesh)

    @classmethod
    def _as_operator(cls, H, ref: "ShardedVector"):
        """H row-sharded over ``ref``'s mesh, zero-embedded when ``ref``
        carries padding (its first axis was rounded up to the mesh
        extent)."""
        if isinstance(H, RowShardedOperator):
            if H.mesh is not ref.mesh or H.n != ref.size:
                raise ValueError(f"operator sharded for n={H.n} on {H.mesh}, "
                                 f"the vector has n={ref.size} on {ref.mesh}")
            return H
        return shard_operator(H, ref.mesh, n=ref.size)

    @classmethod
    def _solve_opts(cls, b, sigma, opType):
        solver, opts = super()._solve_opts(b, sigma, opType)
        if solver == "exact":
            raise NotImplementedError(
                "exact (dense direct) solves take the whole operator on one "
                "device: use TorchVector, or an iterative linearSolver")
        return solver, opts

    @classmethod
    def set_default_mesh(cls, mesh: Optional[Mesh]):
        cls._default_mesh = mesh

    @classmethod
    def from_array(cls, array, mesh: Optional[Mesh] = None,
                   options: Optional[dict] = None) -> "ShardedVector":
        return cls(array, options, mesh=mesh)

    def to_state_dict(self) -> dict:
        """The whole state (padding included) gathered to every rank: a
        collective, so every rank calls it."""
        full = self.mesh.allgather_x(self.array, dim=0)
        return {"kind": np.asarray("sharded"),
                "array": full.detach().cpu().numpy()}

    @classmethod
    def from_state_dict(cls, state: dict, options=None, mesh=None,
                        device=None):
        """Rebuild from :meth:`to_state_dict` output, a dense one, or the
        dict of the JAX package's ``ShardedVector.to_state_dict``."""
        kind = str(state.get("kind", "dense"))
        if kind not in ("sharded", "dense"):
            raise ValueError(f"not a dense or sharded vector state: "
                             f"kind={kind!r}")
        return cls(state["array"], options, mesh=mesh, device=device)


def solve_lanes(mesh: Mesh, solve, op, B, sigmas, X0=None):
    """A batched solve of the lane stack B on the mesh:
    ``solve(op, B_lanes, sigmas_lanes, X0_lanes, reduce)`` runs on this
    rank's lanes over "b" (:func:`~eigensolvers_tpu_torch.ops.
    linear_solvers.lanes_over_b`), one all-gather over "b" after it.  With
    one "x" rank and several "b" ranks every lane group is whole on its
    rank: the solve is lane-local (the operator's local product, no
    reduction, so no collective inside its loop); otherwise the state is
    sharded and every state contraction reduces over "x"."""
    if mesh.shape["x"] == 1 and mesh.shape["b"] > 1:
        op, reduce = getattr(op, "local", op), None
    else:
        reduce = mesh.allreduce_x
    return ls.lanes_over_b(
        mesh, lambda Bl, s, X0l: solve(op, Bl, s, X0l, reduce), B, sigmas,
        X0)


class RowShardedOperator(AbstractOperator):
    """This rank's rows of an (n, n) operator row-sharded over the "x"
    group: an apply all-gathers x over "x" and runs ``local``, the rank's
    row-block product of the whole x (the ``row_matvec`` schedule of
    :mod:`.spmd`); the result stays row-sharded.  ``local`` maps (n,) to
    (n/x,) and lane stacks (m, n) to (m, n/x); with one "x" rank it is the
    whole operator."""

    def __init__(self, local: AbstractOperator, mesh: Mesh, n: int,
                 diag=None):
        super().__init__()
        self.local = local
        self.mesh = mesh
        self.n = int(n)
        self.register_buffer("diag", diag)

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def rows(self) -> slice:
        """This rank's rows."""
        return _rows(self.n, self.mesh)

    @property
    def dtype(self):
        return self.local.dtype

    def matvec(self, x):
        return self.local.matvec(
            self.mesh.allgather_x(x.reshape(-1))).reshape(x.shape)

    def matvec_lanes(self, X):
        return self.local.matvec_lanes(self.mesh.allgather_x(X))

    def diagonal(self):
        return self.diag


class _DenseRows(AbstractOperator):
    """Rows (r, n) of a dense matrix as an operator of the whole x."""

    def __init__(self, rows):
        super().__init__()
        self.register_buffer("rows", rows)

    @property
    def shape(self):
        return tuple(self.rows.shape)

    @property
    def dtype(self):
        return self.rows.dtype

    def matvec(self, x):
        dtype = torch.promote_types(self.rows.dtype, x.dtype)
        require_true_fp32(x.to(dtype))
        return self.rows.to(dtype) @ x.reshape(-1).to(dtype)

    def matvec_lanes(self, X):
        dtype = torch.promote_types(self.rows.dtype, X.dtype)
        require_true_fp32(X.to(dtype))
        return X.to(dtype) @ self.rows.to(dtype).T


class _SliceRows(AbstractOperator):
    """This rank's rows of the whole operator's product: the operator is
    replicated on every rank (sum-of-products factors, diagonals, bands)
    and applied to the whole gathered x."""

    def __init__(self, op: AbstractOperator, rows: slice):
        super().__init__()
        self.op = op
        self.rows = rows

    @property
    def shape(self):
        return (self.rows.stop - self.rows.start, self.op.shape[1])

    @property
    def dtype(self):
        return self.op.dtype

    def matvec(self, x):
        return self.op.matvec(x.reshape(-1))[self.rows]

    def matvec_lanes(self, X):
        return self.op.matvec_lanes(X)[:, self.rows]


def shard_operator(H, mesh: Mesh, n: Optional[int] = None
                   ) -> RowShardedOperator:
    """Row-shard an operator over ``mesh``'s "x" group for states of
    (padded) length ``n`` (default: the operator's, rounded up to the "x"
    extent); this rank keeps:

    * dense (n, n): its rows, applied as one all-gather of x and a local
      (n/x, n) product;
    * a block-sparse ``BSROperator`` whose block rows split evenly over
      "x" (n = nrb*B): its block rows with global column ids, applied as
      one all-gather of x and one rectangular B1/B3 launch (the square
      launch with one "x" rank);
    * anything else (sum-of-products and grouped sum-of-products factors,
      diagonal, banded, callable operators, or a BSR whose rows do not
      split so): the operator replicated, applied to the gathered x, of
      which it keeps its rows.

    The operator is placed on the mesh's device; a numpy or scipy H is
    coerced as :func:`~eigensolvers_tpu_torch.ops.operators.as_operator`
    does.  The diagonal (for Jacobi preconditioning) is sliced the same
    way."""
    op = as_operator(H, device=mesh.device).to(mesh.device)
    xdim = mesh.shape["x"]
    if n is None:
        n = op.shape[0] + (-op.shape[0]) % xdim
    if n % xdim or n < op.shape[0]:
        raise ValueError(f"states of n={n} do not hold the operator's "
                         f"{op.shape[0]} rows in {xdim} equal blocks")
    rows = _rows(n, mesh)
    d = op.diagonal()
    if d is not None:
        d = torch.nn.functional.pad(d, (0, n - d.shape[0]))[rows]
    if isinstance(op, DenseOperator):
        mat = op.mat
        pad = n - mat.shape[0]
        local = _DenseRows(torch.nn.functional.pad(
            mat, (0, pad, 0, pad))[rows].contiguous())
    elif isinstance(op, BSROperator) and op.square \
            and op.n_padded == n and op.dataT.shape[0] % xdim == 0:
        B = op.block_size
        blk = slice(rows.start // B, rows.stop // B)
        local = BSROperator.from_transposed(
            op.dataT[blk], op.idx[blk], rows.stop - rows.start,
            precision=op.precision, ncb=op.dataT.shape[0])
    else:
        whole = op if op.shape[0] == n else PaddedOperator(op, n)
        local = _SliceRows(whole, rows)
    return RowShardedOperator(local, mesh, n, diag=d)
