"""Explicit-collective SPMD operator application.

Counterpart of ``eigensolvers_tpu/parallel/spmd.py``, whose ``shard_map``
bodies write the collective schedule out by hand.  Here every product is
written that way (there is no partitioner to leave it to), with exactly
one collective per call:

* :func:`row_matvec`: all-gather of x over "x", then the rank's purely
  local row-block product; the result stays row-sharded;
* :func:`col_matvec`: the rank's local partial product with its column
  block, then one reduce-scatter over "x" (moves y-partials instead of x);
* :func:`sharded_vdot`: local partial vdot, then one all-reduce over "x".

A row- or column-sharded matrix is the rank's block as a plain tensor
(:func:`place_row_sharded`, :func:`place_col_sharded`); a sharded state is
the rank's block of rows.
"""

from __future__ import annotations

import torch

from ..ops.operators import as_tensor, require_true_fp32
from .mesh import Mesh


def _block(n: int, mesh: Mesh) -> slice:
    k = mesh.shape["x"]
    if n % k:
        raise ValueError(f"dimension {n} does not split over x={k}")
    r = mesh.rank["x"]
    return slice(r * (n // k), (r + 1) * (n // k))


def row_matvec(mesh: Mesh):
    """``mv(H_rows, x)``: ``H_rows`` this rank's (n/k, n) rows, ``x`` its
    (n/k,) block; one all-gather of x, then the local product."""

    def mv(H_blk, x_blk):
        xg = mesh.allgather_x(x_blk)
        dtype = torch.promote_types(H_blk.dtype, xg.dtype)
        require_true_fp32(xg.to(dtype))
        return H_blk.to(dtype) @ xg.to(dtype)

    return mv


def col_matvec(mesh: Mesh):
    """``mv(H_cols, x)``: ``H_cols`` this rank's (n, n/k) columns, ``x`` its
    (n/k,) block; the local partial product, then one reduce-scatter."""

    def mv(H_blk, x_blk):
        dtype = torch.promote_types(H_blk.dtype, x_blk.dtype)
        require_true_fp32(x_blk.to(dtype))
        return mesh.reduce_scatter_x(H_blk.to(dtype) @ x_blk.to(dtype))

    return mv


def sharded_vdot(mesh: Mesh):
    """``vdot(a, b)`` of two row-sharded states: the local vdot, then one
    all-reduce over "x"."""

    def vdot(a_blk, b_blk):
        return mesh.allreduce_x(torch.vdot(a_blk.reshape(-1),
                                           b_blk.reshape(-1)))

    return vdot


def place_row_sharded(H, mesh: Mesh) -> torch.Tensor:
    """This rank's block of rows of a dense (n, n) matrix, on its device."""
    H = as_tensor(H, mesh.device)
    return H[_block(H.shape[0], mesh)].contiguous()


def place_col_sharded(H, mesh: Mesh) -> torch.Tensor:
    """This rank's block of columns of a dense (n, n) matrix."""
    H = as_tensor(H, mesh.device)
    return H[:, _block(H.shape[1], mesh)].contiguous()
