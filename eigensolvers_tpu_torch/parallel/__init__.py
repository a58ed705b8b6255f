"""Mesh-sharded execution on ``torch.distributed``: process meshes, sharded
vectors and operators, explicit-collective products."""
from .mesh import (make_mesh, distributed_initialize, replicated,
                   vector_sharding, batched_vector_sharding,
                   operator_row_sharding, Mesh, collective_counts,
                   reset_collective_counts)
from .sharded import ShardedVector, shard_operator, RowShardedOperator
from .spmd import (row_matvec, col_matvec, sharded_vdot,
                   place_row_sharded, place_col_sharded)

__all__ = ["make_mesh", "distributed_initialize", "replicated",
           "vector_sharding", "batched_vector_sharding",
           "operator_row_sharding", "ShardedVector", "shard_operator",
           "row_matvec", "col_matvec", "sharded_vdot",
           "place_row_sharded", "place_col_sharded", "Mesh",
           "RowShardedOperator", "collective_counts",
           "reset_collective_counts"]
