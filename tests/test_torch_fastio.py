"""The port's native async checkpoint writer (``io/fastwriter.py`` over
``csrc/fastio.cpp``, built with this host's g++ into the package's build
directory): build, write, round-trip, bad paths, and the Krylov-basis
checkpoints of tensor-network states through it, read back by both
packages."""

import os

import numpy as np

from eigensolvers_tpu.utils import checkpointing as jax_ckpt
from eigensolvers_tpu.vectors.ttns import TTNSVector as JaxTTNS

from eigensolvers_tpu_torch.io import AsyncWriter
from eigensolvers_tpu_torch.io import fastwriter
from eigensolvers_tpu_torch.utils import checkpointing
from eigensolvers_tpu_torch.vectors.ttns import TTNSVector, TreeTopology

from test_torch_common import CPU, as_np


def test_native_library_builds_into_the_build_directory():
    """g++ is on this host, so the native path is live; the library lands
    in the port's build directory, never beside the JAX package's source."""
    w = AsyncWriter()
    try:
        assert w.available
        lib = fastwriter.library_path()
        assert lib.exists() and lib.parent == fastwriter.BUILD_DIR
        assert lib.parent.name == "eigensolvers_tpu_torch"
    finally:
        w.close()


def test_async_roundtrip(tmp_path):
    w = AsyncWriter(max_queue=4)
    try:
        rng = np.random.RandomState(0)
        arrays = {f"a{i}": rng.rand(100, 50) for i in range(8)}
        for name, arr in arrays.items():
            w.submit_npz(str(tmp_path / f"{name}.npz"), data=arr)
        assert w.flush() == 0
        assert w.submitted == len(arrays)
        for name, arr in arrays.items():
            loaded = np.load(str(tmp_path / f"{name}.npz"))["data"]
            np.testing.assert_array_equal(loaded, arr)
        # no stray .tmp files (atomic rename)
        assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    finally:
        w.close()


def test_writer_survives_bad_path(tmp_path):
    w = AsyncWriter()
    try:
        w.submit_bytes(str(tmp_path / "nodir" / "x.bin"), b"abc")
        errs = w.flush()
        assert errs >= 1          # error counted, thread alive
        w.submit_bytes(str(tmp_path / "ok.bin"), b"xyz")
        assert w.flush() == errs      # no new errors
        assert open(tmp_path / "ok.bin", "rb").read() == b"xyz"
    finally:
        w.close()


def test_closed_writer_writes_synchronously(tmp_path):
    w = AsyncWriter()
    w.close()
    assert not w.available
    w.submit_bytes(str(tmp_path / "s.bin"), b"sync")
    assert open(tmp_path / "s.bin", "rb").read() == b"sync"
    assert w.flush() == 0 and w.pending() == 0


def test_default_writer_is_shared_and_native():
    a = checkpointing.default_async_writer()
    assert a is checkpointing.default_async_writer()
    assert a is not None and a.available


def test_tree_checkpoint_through_the_writer_loads_in_both(tmp_path):
    """A basis of tree states saved through the native writer loads back
    into the port (exact tensors) and into the JAX package."""
    topo = TreeTopology((-1, 0, 0, 2))
    vecs = [TTNSVector.random(topo, [2, 3, 2, 4], 3, seed=s, device=CPU)
            for s in range(3)]
    w = AsyncWriter()
    try:
        checkpointing.save_checkpoint(str(tmp_path), 7, vecs, {"cumIter": 7},
                                      eigenvalues=np.arange(3.0),
                                      async_writer=w)
        assert w.flush() == 0 and w.submitted == 4
    finally:
        w.close()
    assert checkpointing.latest_tag(str(tmp_path)) == 7
    mine, meta = checkpointing.load_checkpoint(str(tmp_path), 7, TTNSVector,
                                               device=CPU)
    theirs, jmeta = jax_ckpt.load_checkpoint(str(tmp_path), 7, JaxTTNS)
    assert meta["status"] == jmeta["status"] == {"cumIter": 7}
    for v, a, b in zip(vecs, mine, theirs):
        assert a.topo == topo and b.topo.parents == topo.parents
        for t, ta, tb in zip(v.tensors, a.tensors, b.tensors):
            np.testing.assert_array_equal(as_np(ta), as_np(t))
            np.testing.assert_array_equal(tb, as_np(t))
