"""Run a function on several gloo ranks on the CPU, one process each.

The multi-rank semantics of the sharded backend are held on the CPU: a
card takes one NCCL rank, so several ranks need several cards, and where
there is one (or none) gloo ranks stand in for them.  On a machine with
several cards, start one process per card instead (``torchrun
--nproc-per-node``) and call :func:`~.mesh.distributed_initialize`.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(fn, rank, world, workdir, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            rank=rank, world_size=world)
    try:
        out = fn(*args)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, args=(), timeout: float = 120.0,
              tmpdir=None) -> list:
    """``fn(*args)`` on ``world`` gloo ranks (fresh processes, one thread
    each), joined through a file store in a new directory under
    ``tmpdir``; returns every rank's return value, in rank order.  ``fn``
    and ``args`` must pickle (``fn`` a module-level function whose module
    imports without side effects).  A rank that raises fails the call with
    its traceback; ranks still running after ``timeout`` seconds (a
    deadlocked collective) are killed and the call raises TimeoutError."""
    workdir = tempfile.mkdtemp(prefix="ranks", dir=tmpdir)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, workdir, args), daemon=True)
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            raise TimeoutError(f"ranks {hung} of {world} still running "
                               f"after {timeout} s")
        for r, p in enumerate(procs):
            if p.exitcode != 0:
                err = os.path.join(workdir, f"rank{r}.err")
                msg = open(err).read() if os.path.exists(err) else ""
                raise RuntimeError(f"rank {r} of {world} exited with "
                                   f"{p.exitcode}:\n{msg}")
        out = []
        for r in range(world):
            with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(workdir, ignore_errors=True)
