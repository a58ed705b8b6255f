"""The port's sum-of-products operators, ``.op`` parser and molecule models
against the JAX package on the same inputs.

Tolerances (f64 throughout):
* matvec, ``diagonal`` and ``to_dense`` of ``SumOfProductOperator``
  (chunked and not) and ``GroupedSoPOperator``: 1e-12 relative to the
  largest entry (the two differ in summation order only);
* mode fusion and regrouping are exact re-factorizations: the same
  operator to 1e-12;
* ``parse_op_file``: the same ``OpSpec`` (labels, parameters and
  coefficients bit for bit: the same float arithmetic);
* the lowest levels of the pyrazine and CH3CN cuts (eigvalsh of the dense
  forms): 1e-9 relative;
* Lanczos on a SoP operator: the Ritz value nearest the target agrees with
  the JAX run and the exact level to 1e-9 relative (1e-10 inner solves,
  eConv 1e-10)."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from eigensolvers_tpu import JaxVector
from eigensolvers_tpu import inexactLanczosDiagonalization as jax_lanczos
from eigensolvers_tpu.models import molecules as jmol
from eigensolvers_tpu.models import op_parser as jparser
from eigensolvers_tpu.models.synthetic import random_sop_terms
from eigensolvers_tpu.ops import operators as jops

from eigensolvers_tpu_torch import (GroupedSoPOperator, SumOfProductOperator,
                                    TorchVector, calculateTarget)
from eigensolvers_tpu_torch import inexactLanczosDiagonalization as lanczos
from eigensolvers_tpu_torch.convert import operator_from_arrays
from eigensolvers_tpu_torch.models import molecules as tmol
from eigensolvers_tpu_torch.models import op_parser as tparser
from eigensolvers_tpu_torch.ops import operators as tops
from eigensolvers_tpu_torch.utils import profiling
from test_torch_common import CPU, as_np, torch_vec

DIMS = [3, 2, 3, 3, 3, 5]          # tests/test_sop_operator.py's problem


def _close(a, b, tol=1e-12):
    a, b = as_np(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=tol * max(1.0, np.abs(b).max()))


def _terms():
    return random_sop_terms(nDim=6, dims=DIMS, nSum=3, seed=1212)


def _pairs():
    """(name, JAX operator, port operator) for the random SoP problem."""
    terms = _terms()
    jsop = jops.SumOfProductOperator.from_terms(6, DIMS, terms)
    jgrp = jops.GroupedSoPOperator.from_terms(6, DIMS, terms)
    jchunk = jops.SumOfProductOperator(jsop.factors, term_chunk=2)
    return [
        ("plain", jsop,
         tops.SumOfProductOperator.from_terms(6, DIMS, terms, device=CPU)),
        ("chunked", jchunk,
         tops.SumOfProductOperator([as_np(f) for f in jsop.factors],
                                   term_chunk=2, device=CPU)),
        ("grouped", jgrp,
         tops.GroupedSoPOperator.from_terms(6, DIMS, terms, device=CPU)),
    ]


@pytest.mark.parametrize("which", [0, 1, 2], ids=["plain", "chunked",
                                                  "grouped"])
def test_sop_operators_match_jax(which):
    _, jop, top = _pairs()[which]
    assert top.shape == tuple(jop.shape) and top.nSum == jop.nSum
    rng = np.random.RandomState(which)
    for x in (rng.rand(*DIMS), rng.standard_normal(int(np.prod(DIMS)))):
        _close(top.matvec(torch.as_tensor(x)), jop.matvec(jnp.asarray(x)))
    _close(top.diagonal(), jop.diagonal())
    _close(top.to_dense(), jop.to_dense())
    if which == 2:
        for ft, fj in zip(top.factors, jop.factors):
            _close(ft, fj)


def test_chunked_pads_terms_like_jax():
    _, jop, top = _pairs()[1]
    assert top.term_chunk == jop.term_chunk == 2
    assert top.nSum == jop.nSum == 4              # 3 terms, one zero term


@pytest.mark.parametrize("target", [20, 256])
def test_fuse_and_regroup_give_the_same_operator(target):
    terms = _terms()
    fd_t, ft_t, parts_t = tops.fuse_sop_terms(DIMS, terms, target=target)
    fd_j, ft_j, parts_j = jops.fuse_sop_terms(DIMS, terms, target=target)
    assert (fd_t, parts_t) == (fd_j, parts_j)
    for (ct, mt), (cj, mj) in zip(ft_t, ft_j):
        assert ct == cj and sorted(mt) == sorted(mj)
        for d in mt:
            np.testing.assert_array_equal(mt[d], mj[d])
    ref = tops.GroupedSoPOperator.from_terms(6, DIMS, terms, device=CPU)
    fused = tops.GroupedSoPOperator.from_terms(len(fd_t), fd_t, ft_t,
                                               device=CPU)
    parts = [[4, 0], [], [2, 1, 5], [3]]          # any order, a virtual mode
    rd, rt = tops.regroup_sop_terms(DIMS, terms, parts)
    assert (rd, len(rt)) == (jops.regroup_sop_terms(DIMS, terms, parts)[0],
                             len(terms))
    regrouped = tops.GroupedSoPOperator.from_terms(len(rd), rd, rt,
                                                   device=CPU)
    x = np.random.RandomState(2).rand(*DIMS)
    want = ref.matvec(torch.as_tensor(x).reshape(-1))
    _close(fused.matvec(torch.as_tensor(x).reshape(-1)), want)
    # regrouping permutes the modes: permute x and the result alike
    perm = [d for p in parts for d in p]
    xp = np.transpose(x, perm).reshape(-1)
    yp = regrouped.matvec(torch.as_tensor(xp))
    y = as_np(yp).reshape([DIMS[d] for d in perm])
    _close(np.transpose(y, np.argsort(perm)).reshape(-1), as_np(want))
    with pytest.raises(ValueError, match="partition"):
        tops.regroup_sop_terms(DIMS, terms, [[0, 1]])


@pytest.mark.parametrize("name", ["PYR4_OP", "CH3CN_OP"])
def test_parse_op_file_gives_the_same_spec(name):
    st = tparser.parse_op_file(getattr(tmol, name))
    sj = jparser.parse_op_file(getattr(jmol, name))
    assert (st.title, st.mode_labels, st.parameters) == \
        (sj.title, sj.mode_labels, sj.parameters)
    assert [(t.coeff, t.factors) for t in st.terms] == \
        [(t.coeff, t.factors) for t in sj.terms]


def test_op_data_files_ship_with_the_port():
    """The port reads its own copies of the .op files, identical to the
    JAX package's."""
    for name in ("PYR4_OP", "CH3CN_OP"):
        mine, theirs = getattr(tmol, name), getattr(jmol, name)
        assert "eigensolvers_tpu_torch" in mine
        with open(mine, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("build,kw", [
    ("pyrazine4_operator", dict(N=4)),
    ("ch3cn_operator", dict(N=5, nModesCut=4)),
    ("ch3cn_operator", dict(N=5, nModesCut=4, fuse=128)),
], ids=["pyr4", "ch3cn", "ch3cn-fused"])
def test_molecule_cuts_give_the_jax_levels(build, kw):
    top, tspec, _ = getattr(tmol, build)(device=CPU, **kw)
    jop, jspec, _ = getattr(jmol, build)(**kw)
    assert top.dims == tuple(jop.dims)
    Ht, Hj = as_np(top.to_dense()), np.asarray(jop.to_dense())
    _close(Ht, Hj)
    et, ej = np.linalg.eigvalsh(Ht)[:6], np.linalg.eigvalsh(Hj)[:6]
    np.testing.assert_allclose(et, ej, rtol=1e-9)
    x = np.random.RandomState(5).rand(Ht.shape[0])
    _close(top.matvec(torch.as_tensor(x)), jop.matvec(jnp.asarray(x)))


def test_lanczos_on_sop_matches_jax():
    _, jop, top = _pairs()[2]
    ev_exact = np.linalg.eigvalsh(as_np(top.to_dense()))
    target = calculateTarget(ev_exact, 8)
    opts = {"linearSystemArgs": {"linearSolver": "minres", "linearIter": 3000,
                                 "linear_tol": 1e-10, "linear_atol": 1e-12}}
    jv = JaxVector(np.random.RandomState(7).rand(*DIMS), opts)
    evj, _, _ = jax_lanczos(jop, jv, target, 20, 10, 1e-10, writeOut=False)
    evt, uvt, _ = lanczos(top, torch_vec(jv, opts), target, 20, 10, 1e-10,
                          writeOut=False)
    got = np.asarray(evt)[np.argmin(np.abs(np.asarray(evt) - target))]
    ref = np.asarray(evj)[np.argmin(np.abs(np.asarray(evj) - target))]
    exact = ev_exact[np.argmin(np.abs(ev_exact - target))]
    assert abs(got - ref) <= 1e-9 * abs(ref)
    assert abs(got - exact) <= 1e-9 * abs(exact)
    assert tuple(uvt[0].array.shape) == tuple(DIMS)


@pytest.mark.parametrize("which", [0, 1, 2], ids=["plain", "chunked",
                                                  "grouped"])
def test_convert_carries_sop_operators_across(which):
    _, jop, _ = _pairs()[which]
    if which == 2:
        arrays = {"dims": jop.dims, "id_coeff": np.asarray(jop.id_coeff),
                  "groups": [(m, [np.asarray(f) for f in facs])
                             for m, facs in jop.groups],
                  "precision": jop.precision}
    else:
        arrays = {"factors": [np.asarray(f) for f in jop.factors],
                  "term_chunk": jop.term_chunk, "precision": jop.precision}
    top = operator_from_arrays(arrays, CPU)
    assert isinstance(top, GroupedSoPOperator if which == 2
                      else SumOfProductOperator)
    x = np.random.RandomState(11).rand(int(np.prod(DIMS)))
    _close(top.matvec(torch.as_tensor(x)), jop.matvec(jnp.asarray(x)))
    _close(top.diagonal(), jop.diagonal())


def test_sop_constructors_default_to_the_card(monkeypatch):
    """Without ``device`` numpy factors go to the card, which must exist."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tops.SumOfProductOperator.from_terms(6, DIMS, _terms())
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tmol.pyrazine4_operator(N=3)
    op = tmol.pyrazine4_operator(N=3, device="cpu")[0]
    assert op.id_coeff.device.type == "cpu"


# The grouped apply on its physical modes (the contraction kernel's plan,
# plain PyTorch on the CPU): the CH3CN cut at N = 5 on 4 modes, fused at 25
# (pairs of modes: every group is applied mode by mode, a term of modes
# (0, 2, 3) through a middle contraction, and the (2, 3) factor kron(A, B)
# with both modes active) and at 128 (modes 0-2 and 3: the presummed
# 125-wide group is a GEMM), and unfused on 3 modes.
PHYSICAL = {"fuse25": dict(N=5, nModesCut=4, fuse=25),
            "fuse128": dict(N=5, nModesCut=4, fuse=128),
            "unfused3": dict(N=5, nModesCut=3)}


@pytest.mark.parametrize("lanes", [None, 1, 3, 6],
                         ids=["vector", "m1", "m3", "m6"])
@pytest.mark.parametrize("case", list(PHYSICAL))
def test_grouped_apply_on_physical_modes(case, lanes):
    kw = PHYSICAL[case]
    top, tspec, tbases = tmol.ch3cn_operator(device=CPU, **kw)
    top = top.to(CPU)                  # nn.Module.to keeps the plan whole
    jop = jmol.ch3cn_operator(**kw)[0]
    H = np.asarray(jop.to_dense())
    _close(top.to_dense(), H)
    kinds = [s[0] for s in top._steps]
    assert "kernel" in kinds and "batched" not in kinds
    assert ("gemm" in kinds) == (case == "fuse128")
    # The plan: every term of two modes or more starts in a pair launch (the
    # two-mode terms of a pair summed as the fewest Kronecker products); a
    # two-mode term takes no slot (the slots are the longer terms'), and
    # each slot a pair launch writes is read by the fan-in of its term's
    # last mode.
    parts = getattr(top, "_parts", [[d] for d in range(len(top.dims))])
    owner = {d: i for i, p in enumerate(parts) for d in p}
    multi = [len(t.factors) for t in tspec.terms
             if len({owner[d] for d in t.factors}) > 1]
    pairs = [lc for s in top._steps if s[0] == "kernel" for lc in s[2]
             if lc[0] == "pair"]
    slots = sum(s[1] for s in top._steps if s[0] == "kernel")
    assert slots == sum(k > 2 for k in multi)
    summed = sum(getattr(top, lc[4]).shape[0] - len(lc[6]) for lc in pairs)
    assert 0 < summed <= sum(k == 2 for k in multi)
    assert (slots > 0) == (case != "unfused3")     # a term of three modes
    for step in top._steps:
        if step[0] == "kernel":
            written = [d for lc in step[2] if lc[0] == "pair" for d in lc[6]]
            read = [z for lc in step[2] if lc[0] == "mode" and lc[5] is None
                    for z in lc[4] if z is not None]
            assert sorted(written) == sorted(read) == list(range(step[1]))
    # .groups and .factors as the fused build gives them, bit for bit
    if "fuse" in kw:
        dims = [b.N for b in tbases]
        terms = [(t.coeff, {d: np.asarray(tparser._factor_matrix(
            lbl, tbases[d])) for d, lbl in t.factors.items()})
            for t in tspec.terms]
        fd, ft, _ = tops.fuse_sop_terms(dims, terms, target=kw["fuse"])
        old = tops.GroupedSoPOperator.from_terms(len(fd), fd, ft, device=CPU)
        assert old._physical == set() and len(top._physical) > 0
        for (mt, ft_), (mo, fo) in zip(top.groups, old.groups):
            assert mt == mo
            for a, b in zip(ft_, fo):
                assert torch.equal(a, b)
        for a, b in zip(top.factors, old.factors):
            assert torch.equal(a, b)
        _close(top.diagonal(), old.diagonal())
        # the JAX operator converted: dense fused factors, the same answers
        cop = operator_from_arrays(
            {"dims": jop.dims, "id_coeff": np.asarray(jop.id_coeff),
             "groups": [(m, [np.asarray(f) for f in facs])
                        for m, facs in jop.groups]}, CPU)
        assert cop._physical == set()
        for (mc, fc), (mj, fj) in zip(cop.groups, jop.groups):
            assert mc == tuple(mj)
            for a, b in zip(fc, fj):
                np.testing.assert_array_equal(as_np(a), np.asarray(b))
    rng = np.random.RandomState(3)
    n = H.shape[0]
    before = profiling.snapshot()
    if lanes is None:
        x = rng.standard_normal(n)
        got = top.matvec(torch.as_tensor(x))
        _close(got, jop.matvec(jnp.asarray(x)))
        want = H @ x
    else:
        X = rng.standard_normal((lanes, n))
        got = top.matvec_lanes(torch.as_tensor(X))
        want = X @ H.T
    counts = profiling.delta(before)
    _close(got, want)
    assert "es.apply.rowwise" not in counts
    assert counts.get("es.sop.gemm", {}).get("calls", 0) == \
        ((lanes or 1) if case == "fuse128" else 0)
    if lanes and "fuse" in kw:
        _close(cop.matvec_lanes(torch.as_tensor(X)), want)
    _close(top.diagonal(), np.diag(H))


# The pair role's plain version (the CPU route of ``sop_pair``, and the
# reference the kernel is held to on the card) against two one-mode
# contractions, mode a then mode b, on the (pre, Na, mid, Nb, post) view:
# the pre = 1, mid = 1 (adjacent modes) and post = 1 (the last mode) edges.
PAIR_VIEWS = [(1, 3, 2, 4, 5), (2, 3, 1, 4, 5), (2, 3, 4, 5, 1),
              (3, 2, 2, 3, 2)]


@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("view", PAIR_VIEWS,
                         ids=["pre1", "mid1", "post1", "inner"])
def test_pair_plain_is_two_one_mode_contractions(view, m):
    pre, Na, mid, Nb, post = view
    rng = np.random.RandomState(sum(view) + m)
    S, nslot = 4, 2
    A = torch.as_tensor(rng.standard_normal((S, Na, Na)))
    B = torch.as_tensor(rng.standard_normal((S, Nb, Nb)))
    x = torch.as_tensor(rng.standard_normal((m, pre * Na * mid * Nb * post)))
    y0 = torch.as_tensor(rng.standard_normal(x.shape))
    want = []
    for s in range(S):
        u, t = torch.empty_like(x), torch.empty_like(x)
        tops.sop_contract_plain(A[s:s + 1], [x], [u], pre, mid * Nb * post)
        tops.sop_contract_plain(B[s:s + 1], [u], [t], pre * Na * mid, post)
        want.append(t)
    for beta in (False, True):
        outs = [torch.empty_like(x) for _ in range(nslot)]
        y = y0.clone()
        tops.sop_pair_plain(A, B, x, outs, y, pre, mid, post, beta=beta)
        for got, w in zip(outs, want):
            _close(got, w)
        _close(y, sum(want[nslot:]) + (y0 if beta else 0))
    outs = [torch.empty_like(x) for _ in range(S)]        # slots alone
    tops.sop_pair(A, B, x, outs, None, pre, mid, post)   # CPU: the plain
    for got, w in zip(outs, want):
        _close(got, w)


@pytest.mark.parametrize("case", list(PHYSICAL))
def test_plan_has_no_fan_out(case):
    """Every multi-mode term of a kernel group starts in a pair launch: no
    one-mode launch writes a slot from x, and the one-mode launches that
    write slots contract them in place (middles)."""
    top = tmol.ch3cn_operator(device=CPU, **PHYSICAL[case])[0]
    launches = [lc for s in top._steps if s[0] == "kernel" for lc in s[2]]
    assert any(lc[0] == "pair" for lc in launches)
    for lc in launches:
        if lc[0] == "mode" and lc[5] is not None:
            assert lc[4] == lc[5] and None not in lc[4]


def test_plan_of_four_mode_terms():
    """Terms on four modes beside terms on one, two and three: the two
    lowest modes of each in a pair launch into a slot, the third in place
    (one middle launch for both), the fourth in a fan-in; the apply equals
    the dense sum of the terms' Kronecker products."""
    rng = np.random.RandomState(7)
    dims = [2, 3, 2, 3, 2]
    supports = [(0,), (3,), (0, 2), (1, 3), (1, 3), (0, 1, 4), (1, 2, 3, 4),
                (0, 2, 3, 4)]
    terms = [(rng.standard_normal(),
              {d: rng.standard_normal((dims[d], dims[d])) for d in sup})
             for sup in supports]
    slots, plan = tops.plan_terms([(c, {d: torch.as_tensor(m)
                                        for d, m in f.items()})
                                   for c, f in terms])
    assert slots == 3
    assert [lc[1:3] for lc in plan if lc[0] == "pair"] == \
        [(0, 1), (0, 2), (1, 2), (1, 3)]
    middles = [lc for lc in plan if lc[0] != "pair" and lc[3] is not None]
    assert [(lc[0], len(lc[2])) for lc in middles] == [(3, 2)]
    assert middles[0][2] == middles[0][3]
    op = tops.GroupedSoPOperator.from_terms(len(dims), dims, terms,
                                            device=CPU)
    H = sum(c * functools.reduce(np.kron, [f.get(d, np.eye(n))
                                           for d, n in enumerate(dims)])
            for c, f in terms)
    X = rng.standard_normal((3, H.shape[0]))
    _close(op.matvec_lanes(torch.as_tensor(X)), X @ H.T)


@pytest.mark.parametrize("rank", [1, 2, 5])
def test_kron_compress_keeps_the_sum(rank):
    """Five Kronecker products whose mode-a factors span ``rank``
    dimensions come back as ``rank`` products with the same sum."""
    rng = np.random.RandomState(rank)
    basis = rng.standard_normal((rank, 4, 4))
    As = [torch.as_tensor(np.tensordot(rng.standard_normal(rank), basis, 1))
          for _ in range(5)]
    Bs = [torch.as_tensor(rng.standard_normal((3, 3))) for _ in range(5)]
    A, B = tops.kron_compress(As, Bs)
    assert len(A) == len(B) == rank
    want = sum(np.kron(as_np(a), as_np(b)) for a, b in zip(As, Bs))
    _close(sum(np.kron(as_np(a), as_np(b)) for a, b in zip(A, B)), want)
