"""eigensolvers_tpu_torch — the PyTorch/CUDA port of eigensolvers_tpu.

Computes a few interior eigenpairs of large Hermitian operators near a
target energy with inexact shift-and-invert Lanczos, and every eigenpair
in a window with FEAST, the Chebyshev-filtered window solver and spectrum
slicing, over dense vectors (whole, or row-sharded over processes on
``torch.distributed``: ``ShardedVector``) or compressed tensor-network
states (MPS and tree tensor networks), written against the same
``AbstractVector`` contract, entry points, status keys and output files as
the JAX package ``eigensolvers_tpu`` beside it.

Design:
  * compute path: PyTorch tensors on an explicit device; the block-sparse
    SpMV runs hand-written CUDA kernels (``csrc/``) on the card and plain
    PyTorch on the CPU; sum-of-products operators (the ``.op`` molecule
    models) apply as mode-wise einsum contractions;
  * operators are ``torch.nn.Module``s holding their arrays as buffers;
  * no global switches: dtypes are explicit (float64 where the 1e-14
    lindep contract needs it), and fp32 products must run with TF32 off
    (``torch.backends.cuda.matmul.allow_tf32 = False``).

This package never imports jax or ``eigensolvers_tpu``.
"""

from .vectors.abstract import AbstractVector, LINDEP_DEFAULT_VALUE
from .vectors.dense import TorchVector
from .ops.operators import (AbstractOperator, DenseOperator,
                            DiagonalOperator, GroupedSoPOperator,
                            SumOfProductOperator, as_operator)
from .ops.sparse import BSROperator
from .solvers.lanczos import inexactLanczosDiagonalization
from .solvers.feast import feastDiagonalization
from .solvers.chebyshev import chebyshevFilteredDiagonalization
from .solvers.slicing import spectrumSlicingDiagonalization
from .utils.quadrature import quadraturePointsWeights
from .vectors.mps import MPSVector, MPO
from .vectors.ttns import (TTNSVector, TTNO, TreeTopology, parseTree,
                           tree_layout)
from .vectors.mps_sweeps import als_solve, dmrg_eigensolve
from .vectors.ttns_sweeps import tree_als_solve, tree_dmrg_eigensolve
from .vectors.numpy_backend import NumpyVector
from .parallel import ShardedVector, shard_operator
from .utils.subspace import (
    basisTransformation,
    calculateTarget,
    diagonalizeHamiltonian,
    eigenvalueResidual,
    find_nearest,
    get_pick_function_close_to_sigma,
    get_pick_function_maxOvlp,
    lowdinOrtho,
    lowdinOrthoMatrix,
    select_within_range,
)
from .config import (VectorOptions, LinearSystemOptions, CompressOptions,
                     LanczosConfig, FeastConfig, normalize_options)

__version__ = "0.1.0"

__all__ = [
    "AbstractVector",
    "AbstractOperator",
    "DenseOperator",
    "DiagonalOperator",
    "GroupedSoPOperator",
    "SumOfProductOperator",
    "BSROperator",
    "TorchVector",
    "MPSVector",
    "MPO",
    "TTNSVector",
    "TTNO",
    "TreeTopology",
    "parseTree",
    "tree_layout",
    "als_solve",
    "dmrg_eigensolve",
    "tree_als_solve",
    "tree_dmrg_eigensolve",
    "NumpyVector",
    "ShardedVector",
    "shard_operator",
    "LINDEP_DEFAULT_VALUE",
    "as_operator",
    "inexactLanczosDiagonalization",
    "feastDiagonalization",
    "chebyshevFilteredDiagonalization",
    "spectrumSlicingDiagonalization",
    "basisTransformation",
    "diagonalizeHamiltonian",
    "eigenvalueResidual",
    "find_nearest",
    "calculateTarget",
    "get_pick_function_close_to_sigma",
    "get_pick_function_maxOvlp",
    "lowdinOrtho",
    "lowdinOrthoMatrix",
    "select_within_range",
    "quadraturePointsWeights",
    "VectorOptions",
    "LinearSystemOptions",
    "CompressOptions",
    "LanczosConfig",
    "FeastConfig",
    "normalize_options",
]
