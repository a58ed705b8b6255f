"""Process meshes and the collectives of the sharded backend, on
``torch.distributed``.

Counterpart of ``eigensolvers_tpu/parallel/mesh.py``.  The JAX package
pins shardings on a ``jax.sharding.Mesh`` and lets GSPMD insert the
collectives; PyTorch has no compiler that does this for plain tensors, so
here every collective is written out, one process per device:

  * axis ``"x"`` — the state-vector dimension: each rank holds a block of
    the state's rows as a plain tensor; every contraction over the state
    axis is one all-reduce over the ``"x"`` group, every operator apply one
    all-gather of x over it (:mod:`.spmd`);
  * axis ``"b"`` — the batch of independent shifted solves (FEAST
    quadrature nodes x subspace vectors, block-Lanczos seeds): lanes split
    over the ``"b"`` group, gathered once after the solve.

Backends: NCCL on the card, gloo only when the caller asks for the CPU
(``device="cpu"``); there is no switch from one to the other.  Each
collective adds one to its count (:func:`collective_counts`), where it is
issued and nowhere else; a group of one rank issues it too, so the counts
of a step do not depend on the mesh's extents.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..ops.operators import default_device

#: Collectives issued since the last :func:`reset_collective_counts`.
_COUNTS = {"allreduce_x": 0, "allgather_x": 0, "reduce_scatter_x": 0,
           "allgather_b": 0}

# torch 2.13 deprecates the *_tensor names for *_single; older releases
# (2.11 on the card) have only the former.  Whichever exists, here only.
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def collective_counts() -> dict:
    """Collectives issued since the last reset, by kind."""
    return dict(_COUNTS)


def reset_collective_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _rank_device(device) -> torch.device:
    """This process's device: the card (``cuda:<local rank>``) unless the
    caller names the CPU; raises, naming ``device="cpu"``, without a card."""
    dev = default_device(device)
    if dev.type == "cuda" and dev.index is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def distributed_initialize(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, device=None):
    """Join the process group: NCCL on the card, gloo for ``device="cpu"``.

    A no-op when a group already exists.  ``coordinator_address`` is an
    ``init_method`` URL (``tcp://host:port``, ``file:///path``) or a
    ``host:port`` pair; ``num_processes`` and ``process_id`` are the world
    size and this rank.  Without them a single process joins a group of
    one over an in-memory store (nothing is opened or listened on)."""
    if dist.is_initialized():
        return
    dev = default_device(device)
    backend = _backend_for(dev)
    if num_processes is None or num_processes <= 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
        return
    url = coordinator_address
    if url is None:
        raise ValueError("num_processes > 1 needs a coordinator_address")
    if "://" not in url:
        url = "tcp://" + url
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=url, rank=int(process_id),
                            world_size=int(num_processes))


class Mesh:
    """A ("b", "x") mesh of the processes of the default group.

    ``device_mesh`` is the ``torch.distributed.device_mesh.DeviceMesh``;
    ``groups`` its ``"b"`` and ``"x"`` process groups; ``shape`` the
    extents, as the JAX ``Mesh.shape``; ``rank`` this process's coordinate
    on each axis; ``device`` the tensor device of this rank."""

    def __init__(self, batch: int, shard: int, device: torch.device):
        from torch.distributed.device_mesh import init_device_mesh
        self.device = device
        self.device_mesh = init_device_mesh(
            device.type, (batch, shard), mesh_dim_names=("b", "x"))
        self.groups = {a: self.device_mesh.get_group(a) for a in ("b", "x")}
        self.shape = {"b": batch, "x": shard}
        self.rank = {a: self.device_mesh.get_local_rank(a)
                     for a in ("b", "x")}

    def __repr__(self):
        return (f"Mesh(b={self.shape['b']}, x={self.shape['x']}, "
                f"device={self.device})")

    # -- collectives ---------------------------------------------------------
    def allreduce_x(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum (or, with ``op="max"``, maximum) of ``t`` over the "x" group,
        as a new tensor.  ``op="norm"`` combines the ranks' 2-norms ``t``
        into the 2-norm of the whole state: an all-gather of them and their
        norm, which with one rank is ``t`` itself, bit for bit."""
        if op == "norm":
            return torch.linalg.vector_norm(self.allgather_x(t[None], dim=0),
                                            dim=0)
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=_REDUCE_OPS[op], group=self.groups["x"])
        _COUNTS["allreduce_x"] += 1
        return out

    def _gather(self, t, axis, dim):
        """All-gather over ``axis``, the ranks' blocks concatenated along
        ``dim`` in rank order."""
        k = self.shape[axis]
        src = t.contiguous()
        if src.is_complex():
            src = torch.view_as_real(src)
        out = src.new_empty((k * src.shape[0],) + tuple(src.shape[1:]))
        _all_gather(out, src, group=self.groups[axis])
        if t.is_complex():
            out = torch.view_as_complex(out)
        out = out.reshape((k,) + tuple(t.shape))
        return torch.cat(out.unbind(0), dim=dim)

    def allgather_x(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's block of ``t`` over "x", joined along ``dim`` (the
        state axis: the last one of a lane stack)."""
        _COUNTS["allgather_x"] += 1
        return self._gather(t, "x", dim)

    def allgather_b(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's lanes of ``t`` over "b", joined along ``dim``."""
        _COUNTS["allgather_b"] += 1
        return self._gather(t, "b", dim)

    def reduce_scatter_x(self, t: torch.Tensor, dim: int = -1
                         ) -> torch.Tensor:
        """Sum of ``t`` over "x", of which each rank keeps its block along
        ``dim`` (the dual of :meth:`allgather_x`)."""
        k = self.shape["x"]
        moved = t.movedim(dim, 0)
        if moved.shape[0] % k:
            raise ValueError(f"axis of {moved.shape[0]} does not split over "
                             f"x={k}")
        src = moved.contiguous()
        if src.is_complex():
            src = torch.view_as_real(src)
        out = src.new_empty((src.shape[0] // k,) + tuple(src.shape[1:]))
        _reduce_scatter(out, src, group=self.groups["x"])
        if t.is_complex():
            out = torch.view_as_complex(out)
        _COUNTS["reduce_scatter_x"] += 1
        return out.movedim(0, dim)


def make_mesh(batch: int = 1, shard: Optional[int] = None,
              device=None) -> Mesh:
    """Build a ("b", "x") mesh over every rank of the default group:
    ``batch`` lanes of solve parallelism x ``shard``-way state sharding
    (default: all ranks in one "x" row).  Joins a group of one first when
    none exists (:func:`distributed_initialize`).  ``device``: this rank's
    device, the card by default; the group's backend must match it (NCCL
    on the card, gloo on the CPU)."""
    distributed_initialize(device=device)
    dev = _rank_device(device)
    backend = dist.get_backend()
    if backend != _backend_for(dev):
        raise RuntimeError(f"the process group runs {backend}, device {dev} "
                           f"needs {_backend_for(dev)}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    n = dist.get_world_size()
    if shard is None:
        if n % batch:
            raise ValueError(f"{n} ranks not divisible by batch={batch}")
        shard = n // batch
    if batch * shard != n:
        raise ValueError(f"mesh {batch}x{shard} needs {batch * shard} ranks, "
                         f"the group has {n}")
    return Mesh(batch, shard, dev)


# Placement descriptors (the JAX package's NamedShardings, as the axis of
# each tensor dimension: "b", "x" or None for replicated).
def replicated(mesh: Mesh) -> tuple:
    return ()


def vector_sharding(mesh: Mesh, ndim: int = 1) -> tuple:
    """A state's first axis over "x"."""
    return ("x",) + (None,) * (ndim - 1)


def batched_vector_sharding(mesh: Mesh, ndim: int = 1) -> tuple:
    """(batch, n, ...) stacks: lanes over "b", the state over "x"."""
    return ("b", "x") + (None,) * (ndim - 1)


def operator_row_sharding(mesh: Mesh) -> tuple:
    """An (n, n) operator's rows over "x": each rank holds a block of rows,
    its apply all-gathers x and keeps the product row-sharded."""
    return ("x", None)
