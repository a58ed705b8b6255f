"""Carry operators from the JAX package into this one, as stored.

The JAX package's operators hold device arrays; pull them out with numpy
(``np.asarray``) and hand them over here.  Vectors cross with
``TorchVector.from_state_dict(JaxVector.to_state_dict())``.
"""

from __future__ import annotations

from .ops.operators import (AbstractOperator, DenseOperator,
                            GroupedSoPOperator, SumOfProductOperator)
from .ops.sparse import BSROperator


def operator_from_arrays(arrays: dict, device, mesh=None) -> AbstractOperator:
    """Build this package's operator on ``device`` from numpy arrays of a
    JAX operator; with a ``mesh`` (:func:`~eigensolvers_tpu_torch.parallel.
    make_mesh`), row-sharded over it (:func:`~eigensolvers_tpu_torch.
    parallel.shard_operator`) for ``ShardedVector`` states.

    * ``BSROperator``: ``{"dataT": np.asarray(op.dataT), "idx":
      np.asarray(op.idx), "n": op.n, "precision": op.precision}`` — the
      transposed block layout is carried as stored, not re-transposed;
    * ``DenseOperator``: ``{"mat": np.asarray(op.mat), "precision": ...}``;
    * ``SumOfProductOperator``: ``{"factors": [np.asarray(f) for f in
      op.factors], "term_chunk": op.term_chunk, "precision": ...}`` (the
      factors as stored, zero terms of a chunked operator included);
    * ``GroupedSoPOperator``: ``{"dims": op.dims, "groups": [(modes,
      [np.asarray(f) for f in facs]) for modes, facs in op.groups],
      "id_coeff": np.asarray(op.id_coeff), "precision": ...}``.

    ``precision`` may be a name or a ``jax.lax.Precision`` value (its name
    is read; no jax import happens here)."""
    op = _from_arrays(arrays, device)
    if mesh is None:
        return op
    from .parallel import shard_operator
    return shard_operator(op, mesh)


def _from_arrays(arrays, device):
    precision = arrays.get("precision", "highest")
    if "dataT" in arrays:
        return BSROperator.from_transposed(arrays["dataT"], arrays["idx"],
                                           int(arrays["n"]),
                                           precision=precision, device=device)
    if "mat" in arrays:
        return DenseOperator(arrays["mat"], precision=precision,
                             device=device)
    if "factors" in arrays:
        return SumOfProductOperator(arrays["factors"],
                                    term_chunk=arrays.get("term_chunk"),
                                    precision=precision, device=device)
    if "groups" in arrays:
        return GroupedSoPOperator(arrays["dims"], arrays["groups"],
                                  id_coeff=arrays["id_coeff"],
                                  precision=precision, device=device)
    raise ValueError(f"no operator arrays in keys {sorted(arrays)}; "
                     f"expected 'dataT'/'idx'/'n', 'mat', 'factors' or "
                     f"'dims'/'groups'/'id_coeff'")
