"""Two-site ALS / DMRG sweep engines over arbitrary tree topologies (the
JAX package's ``vectors/ttns_sweeps.py``).

Tree generalization of the chain engines in ``mps_sweeps.py``; fills the
sweep-solver role the reference delegates to the external ``ttns2`` package
for true trees (reference: ttnsVector.py:169-196).

The sweep walks an Euler tour of the rooted tree (pre-order DFS, the
numbering contract of
:class:`~eigensolvers_tpu_torch.vectors.ttns.TreeTopology`): each tree edge
``(p, c)`` is optimized as a two-site problem, the orthogonality center
carried along the tour, and the two-site tensor SVD-split with
``maxD``/``eps`` truncation.

Environments are one tensor per directed edge:

* ``down[c]``  — the subtree rooted at ``c``, seen from the ``(p, c)`` bond:
  a three-index ``(bond_bra, ttno_bond, bond_ket)`` tensor for the operator,
  two-index ``(bond_bra, rhs_bond)`` for RHS / deflation states.
* ``up[c]``    — everything *outside* the subtree of ``c`` seen from the same
  bond, built from ``up[parent]`` plus the sibling ``down`` environments.

Placement as in :mod:`~eigensolvers_tpu_torch.vectors.mps_sweeps`: the
environments, the two-sided effective operator and the splits are torch
work on the state's device (each contraction a left-to-right chain of
two-operand einsums, :func:`~eigensolvers_tpu_torch.vectors.ttns.
einsum_chain`); the local iterative solvers (scipy ``eigsh``/``gcrotmk``,
see :func:`~eigensolvers_tpu_torch.vectors.mps_sweeps.local_lowest`) run
on the host and move one local vector each way per matvec
(ROADMAP A.10 would move them onto the device).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from .mps import keep_count, numpy_dtype, result_type, svd, to_tensors, \
    torch_dtype
from .mps_sweeps import (Deflation, _ones, _sweep_change, local_eigen,
                         local_solve)
from .ttns import (TreeTopology, _qr_toward_parent, einsum_chain,
                   sandwich_env, ttns_random, ttns_vdot)


# ----------------------------------------------------------------------------
# environment contractions (integer-subscript einsum)
# ----------------------------------------------------------------------------
def _down_op(topo, x, W, down, i):
    """Operator down-environment of node ``i`` (isometric toward its parent):
    ``E[Ab, Wp, Ak]`` over the (parent, i) bond."""
    return sandwich_env(topo, x, W, x, down, i)


def _up_op(topo, x, W, up, down, p, c):
    """Operator up-environment of child ``c`` of ``p`` (``x[p]`` isometric
    w.r.t. the (p, c) bond): ``E[Bb, w, Bk]`` over that bond.  The sibling
    with the widest operator bond is contracted before ``W[p]`` (as in
    :func:`~eigensolvers_tpu_torch.vectors.ttns.sandwich_env`)."""
    ch = topo.children[p]
    jc = ch.index(c)
    k = len(ch)
    xb = [0, 3] + [5 + 3 * j for j in range(k)]
    ws = [1, 3, 4] + [6 + 3 * j for j in range(k)]
    xk = [2, 4] + [7 + 3 * j for j in range(k)]
    sib = sorted((j for j in range(k) if j != jc),
                 key=lambda j: -W[p].shape[3 + j])
    env = lambda j: [down[ch[j]], [5 + 3 * j, 6 + 3 * j, 7 + 3 * j]]  # noqa
    ops = [up[p], [0, 1, 2], x[p].conj(), xb] + sum(
        (env(j) for j in sib[:1]), []) + [W[p], ws]
    for j in sib[1:]:
        ops += env(j)
    ops += [x[p], xk]
    return einsum_chain(*ops, [5 + 3 * jc, 6 + 3 * jc, 7 + 3 * jc])


def _down_rhs(topo, x, b, down, i):
    """RHS (two-layer <x|b>) down-environment of node ``i``: ``E[Ab, Ck]``."""
    ch = topo.children[i]
    k = len(ch)
    xb = [0, 2] + [3 + 2 * j for j in range(k)]
    bk = [1, 2] + [4 + 2 * j for j in range(k)]
    ops = [x[i].conj(), xb]
    for j, c in enumerate(ch):
        ops += [down[c], [3 + 2 * j, 4 + 2 * j]]
    ops += [b[i], bk]
    return einsum_chain(*ops, [0, 1])


def _up_rhs(topo, x, b, up, down, p, c):
    """RHS up-environment of child ``c`` of ``p``: ``E[Bb, Ck]``."""
    ch = topo.children[p]
    jc = ch.index(c)
    k = len(ch)
    xb = [0, 2] + [3 + 2 * j for j in range(k)]
    bk = [1, 2] + [4 + 2 * j for j in range(k)]
    ops = [up[p], [0, 1], x[p].conj(), xb]
    for j, e in enumerate(ch):
        if j != jc:
            ops += [down[e], [3 + 2 * j, 4 + 2 * j]]
    ops += [b[p], bk]
    return einsum_chain(*ops, [3 + 2 * jc, 4 + 2 * jc])


# ----------------------------------------------------------------------------
# per-edge two-site algebra
# ----------------------------------------------------------------------------
class _Edge:
    """Local two-site problem on tree edge ``(p, c)``.

    The two-site tensor ``theta`` has the canonical layout
    ``(Ap, n_p, B_sib..., n_c, F...)`` — p's parent bond, p's physical index,
    p's other child bonds in child order, c's physical index, c's child
    bonds in order.  ``split`` returns updated site tensors with the new
    (p, c) bond re-inserted at its axis in ``x[p]``.
    """

    def __init__(self, topo: TreeTopology, p: int, c: int):
        self.topo, self.p, self.c = topo, p, c
        self.ch_p = topo.children[p]
        self.jc = self.ch_p.index(c)
        self.ch_c = topo.children[c]
        self.ax = topo.child_axis(p, c)

    # -- theta assembly / split ----------------------------------------------
    def assemble(self, x):
        p, c, jc = self.p, self.c, self.jc
        sp = [0, 1] + [2 if j == jc else 10 + j
                       for j in range(len(self.ch_p))]
        sc = [2, 3] + [30 + f for f in range(len(self.ch_c))]
        out = [0, 1] + [10 + j for j in range(len(self.ch_p)) if j != jc] \
            + [3] + [30 + f for f in range(len(self.ch_c))]
        return einsum_chain(x[p], sp, x[c], sc, out)

    def split(self, theta, maxD, eps, center_to):
        """SVD-split theta; ``center_to`` is 'p' or 'c'.  Returns
        (x_p, x_c, discarded_weight)."""
        nrows = 2 + len(self.ch_p) - 1
        rshape = tuple(theta.shape[:nrows])
        cshape = tuple(theta.shape[nrows:])
        u, s, vh = svd(theta.reshape(math.prod(rshape), math.prod(cshape)))
        keep, s2 = keep_count(s, maxD, eps)
        disc = float(np.sum(s2[keep:]))
        u, s, vh = u[:, :keep], s[:keep].to(u.dtype), vh[:keep]
        if center_to == "c":
            left, right = u, s[:, None] * vh
        else:
            left, right = u * s[None, :], vh
        xp = torch.movedim(left.reshape(rshape + (keep,)), -1, self.ax)
        xc = right.reshape((keep,) + cshape)
        return xp, xc, disc

    # -- local operator / rhs -------------------------------------------------
    def build_heff(self, W, up, down):
        """Precompute the edge's effective operator as TWO tensors — built
        ONCE per edge solve, applied per iterative-solver matvec:

        * ``Pside[Ab, n_po, Bb_sib..., w, Ak, n_pi, Bk_sib...]`` =
          up[p] . W[p] . sibling down-envs (everything on the parent side
          of the edge's TTNO bond ``w``);
        * ``Cside[w, n_co, Fb..., n_ci, Fk...]`` = W[c] . child down-envs.

        A single pairwise chain through theta would carry the outer product
        of several uncontracted TTNO child bonds at multi-child nodes; the
        two-sided precontraction keeps each matvec at two tensordots.
        """
        p, c, jc = self.p, self.c, self.jc
        kp, kc = len(self.ch_p), len(self.ch_c)
        w_child = [5 if j == jc else 9 + 3 * j for j in range(kp)]
        ops = [up[p], [0, 1, 2], W[p], [1, 3, 4] + w_child]
        for j, e in enumerate(self.ch_p):
            if j != jc:
                ops += [down[e], [8 + 3 * j, 9 + 3 * j, 10 + 3 * j]]
        outP = [0, 3] + [8 + 3 * j for j in range(kp) if j != jc] + [5] \
            + [2, 4] + [10 + 3 * j for j in range(kp) if j != jc]
        Pside = einsum_chain(*ops, outP)

        base = 20
        ops = [W[c], [5, 6, 7] + [base + 3 * f + 1 for f in range(kc)]]
        for f, e in enumerate(self.ch_c):
            ops += [down[e], [base + 3 * f, base + 3 * f + 1,
                              base + 3 * f + 2]]
        outC = [5, 6] + [base + 3 * f for f in range(kc)] + [7] \
            + [base + 3 * f + 2 for f in range(kc)]
        Cside = einsum_chain(*ops, outC)
        return Pside, Cside

    def apply_heff(self, Pside, Cside, theta):
        """H_eff @ theta via the precomputed two-sided tensors (two
        tensordots; see build_heff)."""
        nsib = len(self.ch_p) - 1
        kc = len(self.ch_c)
        # contract theta's (n_c, Fk...) with Cside's (n_ci, Fk...)
        t = torch.tensordot(
            theta, Cside,
            dims=([2 + nsib] + [3 + nsib + f for f in range(kc)],
                  [2 + kc] + [3 + kc + f for f in range(kc)]))
        # t: (Ak, n_pi, Bk_sib..., w, n_co, Fb...)
        return torch.tensordot(
            Pside, t,
            dims=([3 + nsib, 4 + nsib]
                  + [5 + nsib + j for j in range(nsib)] + [2 + nsib],
                  [0, 1] + [2 + j for j in range(nsib)] + [2 + nsib]))

    def project_rhs(self, b, up_b, down_b):
        """Project the RHS (or a deflation state) onto the local two-site
        basis: output in the theta layout."""
        p, c, jc = self.p, self.c, self.jc
        kp, kc = len(self.ch_p), len(self.ch_c)
        cb_child = [3 if j == jc else 11 + 2 * j for j in range(kp)]
        ops = [up_b[p], [0, 1], b[p], [1, 2] + cb_child]
        for j, e in enumerate(self.ch_p):
            if j != jc:
                ops += [down_b[e], [10 + 2 * j, 11 + 2 * j]]
        base = 10 + 2 * kp
        ops += [b[c], [3, 7] + [base + 2 * f + 1 for f in range(kc)]]
        for f, e in enumerate(self.ch_c):
            ops += [down_b[e], [base + 2 * f, base + 2 * f + 1]]
        out = [0, 2] + [10 + 2 * j for j in range(kp) if j != jc] \
            + [7] + [base + 2 * f for f in range(kc)]
        return einsum_chain(*ops, out)


# ----------------------------------------------------------------------------
# shared sweep machinery
# ----------------------------------------------------------------------------
def _canonicalize_to_root(topo, x):
    """Leaves-to-root QR; after this every non-root node is an isometry
    toward its parent and the center sits at the root."""
    for i in range(len(topo) - 1, 0, -1):
        _qr_toward_parent(topo, x, i)


def _init_down_ops(topo, x, W):
    down = [None] * len(topo)
    for i in range(len(topo) - 1, 0, -1):
        down[i] = _down_op(topo, x, W, down, i)
    return down


def _init_down_rhs(topo, x, b):
    down = [None] * len(topo)
    for i in range(len(topo) - 1, 0, -1):
        down[i] = _down_rhs(topo, x, b, down, i)
    return down


def _euler_sweep(topo, x, maxD, eps, solve_edge, after_descend, after_ascend):
    """One full Euler-tour sweep; ``solve_edge(edge, theta0) -> theta``;
    the ``after_*`` callbacks refresh environments.  Center starts and ends
    at the root."""

    def visit(p):
        for c in topo.children[p]:
            edge = _Edge(topo, p, c)
            if topo.children[c]:
                theta = solve_edge(edge, edge.assemble(x))
                x[p], x[c], _ = edge.split(theta, maxD, eps, "c")
                after_descend(edge)
                visit(c)
            theta = solve_edge(edge, edge.assemble(x))
            x[p], x[c], _ = edge.split(theta, maxD, eps, "p")
            after_ascend(edge)

    visit(0)


# ----------------------------------------------------------------------------
# tree ALS linear-system solver
# ----------------------------------------------------------------------------
def tree_als_solve(topo: TreeTopology, ttno_tensors, b, sigma, x0=None,
                   sign: float = 1.0, maxD: Optional[int] = 64,
                   eps: float = 1e-10, nSweep: int = 20,
                   convTol: float = 1e-6, local_tol: float = 1e-8,
                   local_maxiter: int = 200, dtype=None, device=None):
    """Solve ``sign * (sigma*I - H) x = b`` by two-site ALS sweeps on a tree
    (reference role: ttns2 ``LinearSystem`` sweeps, ttnsVector.py:169-196;
    chain counterpart: :func:`mps_sweeps.als_solve`).  Runs on the device
    of ``b`` (numpy tensors go to ``device``, default the card)."""
    b = to_tensors(b, device)
    dev = b[0].device
    sigma = sigma.item() if hasattr(sigma, "item") else sigma
    dtype = torch_dtype(dtype) if dtype is not None else result_type(
        torch_dtype(np.asarray(sigma).dtype), *b, *ttno_tensors)
    L = len(topo)
    x = to_tensors(x0 if x0 is not None else b, dev, dtype)
    b = [t.to(dtype) for t in b]
    W = to_tensors(ttno_tensors, dev, dtype)

    if L == 1:
        n = x[0].shape[1]
        A = sign * (sigma * torch.eye(n, dtype=dtype, device=dev) - W[0][0])
        return [torch.linalg.solve(A, b[0][0])[None]]

    _canonicalize_to_root(topo, x)
    down = _init_down_ops(topo, x, W)
    down_b = _init_down_rhs(topo, x, b)
    up = [None] * L
    up_b = [None] * L
    up[0] = _ones((1, 1, 1), dtype, dev)
    up_b[0] = _ones((1, 1), dtype, dev)

    def solve_edge(edge, theta0):
        rhs = edge.project_rhs(b, up_b, down_b)
        Pside, Cside = edge.build_heff(W, up, down)
        return local_solve(
            lambda t: sign * (sigma * t - edge.apply_heff(Pside, Cside, t)),
            rhs, theta0, local_tol, local_maxiter, dtype)

    def after_descend(edge):
        up[edge.c] = _up_op(topo, x, W, up, down, edge.p, edge.c)
        up_b[edge.c] = _up_rhs(topo, x, b, up_b, down_b, edge.p, edge.c)

    def after_ascend(edge):
        down[edge.c] = _down_op(topo, x, W, down, edge.c)
        down_b[edge.c] = _down_rhs(topo, x, b, down_b, edge.c)

    vdot = lambda a, c: ttns_vdot(topo, a, c)  # noqa: E731
    prev = None
    for sweep in range(nSweep):
        _euler_sweep(topo, x, maxD, eps, solve_edge,
                     after_descend, after_ascend)
        if prev is not None and _sweep_change(prev, x, vdot) < convTol:
            break
        prev = list(x)
    return x


# ----------------------------------------------------------------------------
# tree DMRG eigensweep
# ----------------------------------------------------------------------------
def tree_dmrg_eigensolve(topo: TreeTopology, ttno_tensors,
                         dims: Sequence[int], x0=None, nStates: int = 1,
                         maxD: Optional[int] = 32, eps: float = 1e-10,
                         nSweep: int = 30, convTol: float = 1e-9,
                         seed: int = 0, dtype=np.float64, device=None):
    """Two-site DMRG on a tree: lowest ``nStates`` eigenpairs of the TTNO.

    Tree counterpart of :func:`mps_sweeps.dmrg_eigensolve` (reference role:
    ``ttns2.eigenStateComputations`` DMRG guess generation on trees,
    unittests/test_feast_ttns.py:64-73).  Excited states by hard-projection
    deflation in the local two-site problems.  Runs on the device of the
    TTNO tensors (numpy tensors go to ``device``, default the card).

    :returns: (energies list, list of TTNS tensor-lists)
    """
    W = to_tensors(ttno_tensors, device, dtype)
    energies, states = [], []
    for istate in range(nStates):
        e, xs = _tree_dmrg_one_state(topo, W, dims,
                                     x0 if istate == 0 else None,
                                     states, maxD, eps, nSweep, convTol,
                                     seed + istate, torch_dtype(dtype))
        energies.append(e)
        states.append(xs)
    return energies, states


def _tree_dmrg_one_state(topo, W, dims, x0, lower_states, maxD, eps,
                         nSweep, convTol, seed, dtype):
    L = len(topo)
    dev = W[0].device
    if x0 is not None:
        x = to_tensors(x0, dev, dtype)
    else:
        x = ttns_random(topo, dims, maxD or 8, seed=seed,
                        dtype=numpy_dtype(dtype), device=dev)

    if L == 1:
        # dense eigh gives all states: the k-th excited state is column k
        ev, uv = torch.linalg.eigh(W[0][0])
        k = min(len(lower_states), uv.shape[1] - 1)
        return float(ev[k]), [uv[:, k][None]]

    _canonicalize_to_root(topo, x)
    x[0] = x[0] / np.sqrt(abs(ttns_vdot(topo, x, x)))

    down = _init_down_ops(topo, x, W)
    up = [None] * L
    up[0] = _ones((1, 1, 1), dtype, dev)

    # deflation environments: one RHS-style env pair per lower state
    denvs = [(_init_down_rhs(topo, x, s), [None] * L, s)
             for s in lower_states]
    for _, up_s, _s in denvs:
        up_s[0] = _ones((1, 1), dtype, dev)

    penalty = 100.0 * max(1.0, max(float(w.abs().max()) for w in W))
    state = {"energy": None, "loc_tol": 1e-4}

    def solve_edge(edge, theta0):
        shape = tuple(theta0.shape)
        Pside, Cside = edge.build_heff(W, up, down)
        defl = Deflation([edge.project_rhs(s, up_s, down_s)
                          for down_s, up_s, s in denvs], penalty)
        theta0 = defl.start(theta0, edge.p * 131 + edge.c)
        apply = defl.wrap(lambda v: edge.apply_heff(
            Pside, Cside, v.reshape(shape)).reshape(-1))
        e, theta = local_eigen(apply, theta0, state["loc_tol"], dtype,
                               energy_fallback=state["energy"],
                               deflated=defl.D is not None)
        state["energy"] = e
        return theta

    def after_descend(edge):
        up[edge.c] = _up_op(topo, x, W, up, down, edge.p, edge.c)
        for down_s, up_s, s in denvs:
            up_s[edge.c] = _up_rhs(topo, x, s, up_s, down_s, edge.p, edge.c)

    def after_ascend(edge):
        down[edge.c] = _down_op(topo, x, W, down, edge.c)
        for down_s, up_s, s in denvs:
            down_s[edge.c] = _down_rhs(topo, x, s, down_s, edge.c)

    energy = None
    for sweep in range(nSweep):
        state["loc_tol"] = 1e-4 if sweep < 2 else max(convTol * 1e-2, 1e-11)
        _euler_sweep(topo, x, maxD, eps, solve_edge,
                     after_descend, after_ascend)
        e = state["energy"]
        if energy is not None and e is not None and \
                abs(e - energy) <= convTol * max(1.0, abs(e)):
            energy = e
            break
        energy = e

    x[0] = x[0] / np.sqrt(abs(ttns_vdot(topo, x, x)))
    return energy, x
