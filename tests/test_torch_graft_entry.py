"""The port's entry points (``eigensolvers_tpu_torch.graft_entry``) on the
CPU, beside the JAX package's ``__graft_entry__``: the fused step of
``entry()`` on the same inputs, the 4-rank dry run on gloo ranks, and the
collective audit of the sharded step at 1, 2 and 4 ranks.

The audit pins the port's own counts per step (``_COLLECTIVE_BUDGET``):
per MINRES pass 2 all-reduces and 1 all-gather over "x", once per step 4
and 3, for every operator type and mesh size; per pass no more than the
JAX package's in-loop count for the type (its ``weak_scaling(4)`` on the
8-virtual-device mesh: dense 3, SoP 4, BSR 3).  ``chip_smoke.py`` holds
``weak_scaling(1)`` on the card to the same pins."""

import numpy as np
import pytest
import torch

import jax
import __graft_entry__ as jge

from eigensolvers_tpu_torch import graft_entry as ge

# one intra-op thread per worker, as every port test that imports
# test_torch_common has: the audit's one-rank baseline runs in this
# process, and its wall bound compares it with gloo ranks that run one
# thread each (parallel/launch.py).  Without the pin the baseline's threads
# depended on which files the worker had run before: with the default
# threads it ran several times faster than a one-thread rank, and the
# bound failed when the other workers loaded the host.
torch.set_num_threads(1)

PIN = {"per_pass": {"allreduce_x": 2, "allgather_x": 1},
       "one_shot": {"allreduce_x": 4, "allgather_x": 3}}


def test_entry_matches_the_jax_entry():
    """One fused step on the CH3CN cut (n = 1728, f32, 100 MINRES
    iterations, rtol 1e-3), the same basis in both packages.  Both solves
    stop at the iteration cap (residual ~0.043), where the two f32
    trajectories part at ~5e-3 of a vector: held are the residuals (within
    5 %), the spanned subspace (singular values of the new vectors'
    overlap above 1 - 1e-3; 0.99994 measured), the new overlap columns to
    1e-5 (2e-6) and the H columns to 2e-3 of their largest (6.6e-5 of
    0.052 measured)."""
    fn, args = ge.entry(device="cpu")
    out = fn(*args)
    jfn, jargs = jge.entry()
    jout = jfn(*jargs)
    jax.block_until_ready(jout)
    nv = out.new_vectors.numpy().astype(np.float64)
    jnv = np.asarray(jout.new_vectors).astype(np.float64)
    assert nv.shape == (2, 1728) and np.all(np.isfinite(nv))
    assert out.new_vectors.device.type == "cpu"
    assert np.all(np.abs(np.linalg.norm(nv, axis=1) - 1) < 1e-3)
    np.testing.assert_allclose(out.solve_resnorms,
                               np.asarray(jout.solve_resnorms), rtol=0.05)
    assert np.linalg.svd(nv @ jnv.T)[1].min() > 1 - 1e-3
    np.testing.assert_allclose(out.s_cols, np.asarray(jout.s_cols),
                               atol=1e-5)
    h = np.asarray(jout.h_cols)
    assert np.abs(out.h_cols - h).max() <= 2e-3 * np.abs(h).max()


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ge.entry()


def test_dryrun_multichip_4(tmp_path):
    """A (2, 2) mesh of gloo ranks: one step with the seeds over "b", then
    FEAST on the same mesh, with the JAX package's asserts inside."""
    got = ge.dryrun_multichip(4, device="cpu")
    assert got["mesh"] == (2, 2) and got["n"] == 64
    assert np.all(np.abs(got["norms"] - 1) < 1e-3)
    assert got["feast_ev"].shape == (3,) and np.all(
        np.isfinite(got["feast_ev"]))


@pytest.fixture(scope="module")
def audit():
    return ge.weak_scaling(4, rows_per_device=128, reps=2, device="cpu")


@pytest.mark.parametrize("kind", ["dense", "sop", "bsr"])
def test_weak_scaling_counts_are_pinned_at_every_size(audit, kind):
    rows = audit[kind]
    assert set(rows) == {1, 2, 4}
    for d, row in rows.items():
        for part, want in PIN.items():
            assert {k: v for k, v in row[part].items() if v} == want, (d, row)
        assert row["in_loop"] == 3 <= ge._JAX_IN_LOOP[kind]
        assert row["n_collective_execs"] == 3 * 50 + 7
        assert row["attributed_upper_ms"] > 0 and row["wall_ms"] > 0


def test_weak_scaling_dense_weak_scales(audit):
    assert [audit["dense"][d]["n"] for d in (1, 2, 4)] == [128, 256, 512]
    assert audit["sop"][4]["n"] == 256 and audit["bsr"][4]["n"] == 2048
