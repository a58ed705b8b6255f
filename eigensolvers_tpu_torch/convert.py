"""Carry operators from the JAX package into this one, as stored.

The JAX package's operators hold device arrays; pull them out with numpy
(``np.asarray``) and hand them over here.  Vectors cross with
``TorchVector.from_state_dict(JaxVector.to_state_dict())``.
"""

from __future__ import annotations

from .ops.operators import AbstractOperator, DenseOperator
from .ops.sparse import BSROperator


def operator_from_arrays(arrays: dict, device) -> AbstractOperator:
    """Build this package's operator on ``device`` from numpy arrays of a
    JAX operator.

    * ``BSROperator``: ``{"dataT": np.asarray(op.dataT), "idx":
      np.asarray(op.idx), "n": op.n, "precision": op.precision}`` — the
      transposed block layout is carried as stored, not re-transposed;
    * ``DenseOperator``: ``{"mat": np.asarray(op.mat), "precision": ...}``.

    ``precision`` may be a name or a ``jax.lax.Precision`` value (its name
    is read; no jax import happens here)."""
    precision = arrays.get("precision", "highest")
    if "dataT" in arrays:
        return BSROperator(arrays["dataT"], arrays["idx"], int(arrays["n"]),
                           precision=precision, device=device)
    if "mat" in arrays:
        return DenseOperator(arrays["mat"], precision=precision,
                             device=device)
    raise ValueError(f"no operator arrays in keys {sorted(arrays)}; "
                     f"expected 'dataT'/'idx'/'n' or 'mat'")
