"""TTNSVector — tree-tensor-network-state backend of the AbstractVector
contract (the JAX package's ``vectors/ttns.py``, on torch tensors).

This is the direct counterpart of the reference's TTNS backend
(reference: ttnsVector.py:18-44, whose heavy lifting lives in the external
``ttns2`` package — ``parseTree`` topologies, sweep engines): a compressed
state over an arbitrary rooted tree of modes, not just a chain.  It inherits
every contract method — including the compressed-Krylov shifted solves,
whole-set orthogonalization, and the S/H subspace assembly — from
:class:`~eigensolvers_tpu_torch.vectors.mps.MPSVector` by overriding only
the raw tensor-algebra hooks (``_vdot_t``/``_add_t``/``_scale_t``/
``_compress_t``/``_mpo``/``_wrap``).  A chain topology reproduces
MPSVector exactly.

Representation
--------------
* Nodes are numbered in **pre-order DFS** (every subtree is a contiguous
  index range; the root is node 0), one physical mode per node.
* Node ``i`` carries a tensor with axes ``(D_parent, n_i, D_child_1, ...,
  D_child_k)`` — children in increasing node order; the root's parent bond
  has dimension 1.  A chain is the degenerate tree
  ``parents = (-1, 0, 1, ...)`` with the same (D_l, n, D_r) site shapes as
  the MPS backend.
* Compression = leaves-to-root QR canonicalization, then a root-to-leaves
  SVD truncation pass that moves the orthogonality center down each branch
  and back.

The operator enters as a TTNO (the tree analog of the MPO), built
bond-compressed from the stacked sum-of-products factors.

Placement as in :mod:`~eigensolvers_tpu_torch.vectors.mps`: torch tensors
on the state's device (default the card), float64/complex128, one host read
of the singular values per truncated bond.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .mps import (MPSVector, Array, default_device, keep_count,
                  operator_factors, result_type, scalar, svd, to_tensors,
                  mps_scale)


# ----------------------------------------------------------------------------
# topology
# ----------------------------------------------------------------------------
class TreeTopology:
    """Rooted tree over nodes 0..L-1 in pre-order DFS numbering."""

    def __init__(self, parents: Sequence[int]):
        parents = tuple(int(p) for p in parents)
        assert parents[0] == -1, "node 0 must be the root"
        for i, p in enumerate(parents[1:], 1):
            assert 0 <= p < i, f"node {i}: parent {p} must precede it"
        self.parents = parents
        L = len(parents)
        children: List[List[int]] = [[] for _ in range(L)]
        for i in range(1, L):
            children[parents[i]].append(i)
        self.children = tuple(tuple(c) for c in children)
        # subtree sizes + pre-order check (each subtree contiguous)
        size = [1] * L
        for i in range(L - 1, 0, -1):
            size[parents[i]] += size[i]
        self.subtree_size = tuple(size)
        for i in range(L):
            off = i + 1
            for c in self.children[i]:
                assert c == off, \
                    f"not pre-order: child {c} of {i}, expected {off}"
                off += size[c]

    def __len__(self):
        return len(self.parents)

    def __eq__(self, other):
        return isinstance(other, TreeTopology) and \
            self.parents == other.parents

    def __hash__(self):
        return hash(self.parents)

    def child_axis(self, p: int, c: int) -> int:
        """Axis of child bond c in node p's tensor."""
        return 2 + self.children[p].index(c)

    @classmethod
    def chain(cls, L: int) -> "TreeTopology":
        return cls((-1,) + tuple(range(L - 1)))

    @classmethod
    def from_nested(cls, nested) -> "TreeTopology":
        """Build from a nested-list tree shape, e.g. ``[[], [[], []]]`` is a
        root with two children, the second of which has two leaf children.
        Node numbers are assigned in pre-order (parity with the reference's
        ``ttns2.parseTree`` role)."""
        parents = [-1]

        def walk(sub, me):
            for child in sub:
                parents.append(me)
                walk(child, len(parents) - 1)

        walk(nested, 0)
        return cls(parents)


parseTree = TreeTopology.from_nested   # reference-parity alias


def tree_layout(nested):
    """Build (topology, mode partition) from an MCTDH-style tree layout.

    ``nested`` is ``(modes, children)`` per node — ``modes`` a list of
    ORIGINAL mode indices attached to that node (often empty for internal
    coordinate-free nodes, multi-element for fused leaves), ``children`` a
    list of nested nodes.  Returns ``(TreeTopology, parts)`` in pre-order;
    ``parts`` feeds ``build_sop_operator(mode_parts=...)`` so the
    operator's mode grid matches the tree one-node-per-(super-)mode
    (reference layouts: examples/ttns2_ch3cn_Block.py:62-76).
    """
    parents = [-1]
    parts = [list(nested[0])]

    def walk(children, me):
        for modes, sub in children:
            parents.append(me)
            parts.append(list(modes))
            walk(sub, len(parents) - 1)

    walk(nested[1], 0)
    return TreeTopology(parents), parts


# ----------------------------------------------------------------------------
# contractions along a fixed pairwise path
# ----------------------------------------------------------------------------
def einsum_chain(*args):
    """``torch.einsum`` in sublist form (operand, indices, ..., output),
    contracted strictly left to right: operand 0 with 1, the result with 2,
    and so on, each step one two-operand einsum (a batched GEMM) that keeps
    only the indices a later operand or the output still needs.  Callers
    order the operands so consecutive ones share indices; a searched path
    may end in a many-operand step with a far larger intermediate."""
    ops, subs, out = list(args[0:-1:2]), list(args[1:-1:2]), list(args[-1])
    dtype = result_type(*ops)
    ops = [o.to(dtype) for o in ops]
    if len(ops) == 1:
        return torch.einsum(ops[0], subs[0], out)
    acc, acc_sub = ops[0], list(subs[0])
    for k in range(1, len(ops)):
        if k == len(ops) - 1:
            keep = out
        else:
            later = set(out).union(*[set(s) for s in subs[k + 1:]])
            keep = [i for i in dict.fromkeys(acc_sub + list(subs[k]))
                    if i in later]
        acc = torch.einsum(acc, acc_sub, ops[k], list(subs[k]), keep)
        acc_sub = keep
    return acc


# ----------------------------------------------------------------------------
# tree tensor algebra
# ----------------------------------------------------------------------------
def ttns_random(topo: TreeTopology, dims: Sequence[int], maxD: int,
                seed: int = 0, dtype=np.float64, device=None) -> List[Array]:
    """Random TTNS with bond dims capped by maxD and the entanglement limit
    (min of the two subtree dimensions across each bond); numpy
    ``RandomState(seed)`` draws placed on ``device`` (default the card)."""
    rng = np.random.RandomState(seed)
    L = len(topo)
    # python ints: an int64 product overflows at production sizes (42^12 ~
    # 3e19), yielding NEGATIVE bond dims through n_total // sub[i]
    n_total = 1
    for d in dims:
        n_total *= int(d)
    sub = [1] * L     # subtree physical dimension per node
    for i in range(L - 1, -1, -1):
        sub[i] = int(dims[i])
        for c in topo.children[i]:
            sub[i] *= sub[c]
    bond = [1] * L   # bond[i] = dim of (i -> parent) bond; root keeps 1
    for i in range(1, L):
        bond[i] = int(min(maxD, sub[i], n_total // sub[i]))
    ts = []
    for i in range(L):
        shape = (bond[i] if i else 1, int(dims[i])) + \
            tuple(bond[c] for c in topo.children[i])
        t = rng.standard_normal(shape)
        if np.issubdtype(np.dtype(dtype), np.complexfloating):
            t = t + 1j * rng.standard_normal(shape)
        ts.append(t.astype(dtype))
    return to_tensors(ts, default_device(device))


def ttns_vdot(topo: TreeTopology, bra: List[Array], ket: List[Array]):
    """<bra|ket> by bottom-up transfer contraction (children before
    parents; pre-order numbering makes reverse index order valid); a host
    scalar."""
    L = len(topo)
    dtype = result_type(*bra, *ket)
    env: List[Optional[Array]] = [None] * L
    for i in range(L - 1, -1, -1):
        T = bra[i].to(dtype).conj()          # (p, n, c1..ck)
        for c in topo.children[i]:
            # contract current axis 2 (next child bond), appending the
            # ket-side child bond at the end
            T = torch.tensordot(T, env[c], dims=([2], [0]))
        k = len(topo.children[i])
        env[i] = torch.tensordot(T, ket[i].to(dtype),
                                 dims=(list(range(1, k + 2)),
                                       list(range(1, k + 2))))   # (pA, pB)
    return scalar(env[0][0, 0])


ttns_scale = mps_scale


def ttns_add(topo: TreeTopology, a: List[Array], b: List[Array]) -> List[Array]:
    """Exact direct-sum addition: block-diagonal on every tree bond."""
    L = len(topo)
    dtype = result_type(*a, *b)
    if L == 1:
        return [a[0].to(dtype) + b[0].to(dtype)]
    out = []
    for i in range(L):
        Ai, Bi = a[i].to(dtype), b[i].to(dtype)
        fixed = lambda ax: ax == 1 or (i == 0 and ax == 0)  # noqa: E731
        shape = [sA if fixed(ax) else sA + Bi.shape[ax]
                 for ax, sA in enumerate(Ai.shape)]
        t = Ai.new_zeros(shape)
        t[tuple(slice(None) if fixed(ax) else slice(0, sA)
                for ax, sA in enumerate(Ai.shape))] = Ai
        t[tuple(slice(None) if fixed(ax) else slice(sA, None)
                for ax, sA in enumerate(Ai.shape))] = Bi
        out.append(t)
    return out


def _qr_toward_parent(topo, ts, i):
    """Make node i an isometry w.r.t. its parent bond; absorb R upward."""
    T = ts[i]
    Dp = T.shape[0]
    rest = T.shape[1:]
    q, r = torch.linalg.qr(T.reshape(Dp, -1).T)     # (rest, k), (k, Dp)
    ts[i] = q.T.reshape((q.shape[1],) + tuple(rest))
    p = topo.parents[i]
    ax = topo.child_axis(p, i)
    ts[p] = torch.movedim(torch.tensordot(ts[p], r, dims=([ax], [1])), -1, ax)


def ttns_compress(topo: TreeTopology, ts: List[Array],
                  maxD: Optional[int] = None,
                  eps: float = 0.0) -> Tuple[List[Array], float]:
    """Canonicalize (leaves-to-root QR), then truncate every bond with the
    orthogonality center moved along a DFS walk (exact local SVD truncation
    at each bond — the tree generalization of the MPS two-sweep form).

    :returns: (compressed tensors, discarded weight estimate)
    """
    L = len(topo)
    ts = list(ts)
    for i in range(L - 1, 0, -1):      # children before parents
        _qr_toward_parent(topo, ts, i)
    discarded = [0.0]

    def down(p):
        for c in topo.children[p]:
            ax = topo.child_axis(p, c)
            T = ts[p]
            D = T.shape[ax]
            M = torch.movedim(T, ax, -1)
            other = tuple(M.shape[:-1])
            u, s, vh = svd(M.reshape(-1, D))
            keep, s2 = keep_count(s, maxD, eps)
            discarded[0] += float(np.sum(s2[keep:]))
            ts[p] = torch.movedim(u[:, :keep].reshape(other + (keep,)), -1,
                                  ax)
            carry = s[:keep, None].to(vh.dtype) * vh[:keep]   # (keep, D)
            ts[c] = torch.tensordot(carry, ts[c], dims=([1], [0]))
            down(c)                     # center is now at c
            _qr_toward_parent(topo, ts, c)   # move center back to p

    down(0)
    return ts, discarded[0]


def ttns_dense(topo: TreeTopology, ts: List[Array]) -> Array:
    """Densify to the full tensor, physical axes in node (pre-order) order
    (small test systems only)."""
    L = len(topo)
    val: List[Optional[Array]] = [None] * L
    for i in range(L - 1, -1, -1):
        T = ts[i]                       # (p, n, c1..ck)
        for c in topo.children[i]:
            T = torch.tensordot(T, val[c], dims=([2], [0]))
        val[i] = T.reshape(T.shape[0], -1)
    return val[0][0]


def ttns_embed_physical(tensors: List[Array], parts, n_old: int,
                        n_new: int, device=None) -> List[Array]:
    """Exact embedding of a TTNS between HO basis-set sizes: each physical
    index of every (super-)mode zero-pads from ``n_old`` to ``n_new``.

    Node tensors are ``(parent_bond, prod(n) over the node's modes,
    child bonds)``; the physical axis is reshaped to per-mode indices,
    padded per mode, and reshaped back — a flat pad of the product index
    would scramble the ``(i, j) -> i*n + j`` fused-leaf encoding.  Used by
    the CH3CN production ladders (rung-to-rung seeding).  Numpy tensors go
    to ``device`` (default the card)."""
    out = []
    for t, p in zip(to_tensors(tensors, device), parts):
        m = len(p)
        if m == 0:
            out.append(t.clone())
            continue
        head, tail = t.shape[0], tuple(t.shape[2:])
        tt = t.reshape((head,) + (n_old,) * m + tail)
        pad = []          # torch.nn.functional.pad: last axis first
        for ax in range(tt.ndim - 1, -1, -1):
            pad += [0, n_new - n_old] if 1 <= ax <= m else [0, 0]
        tt = torch.nn.functional.pad(tt, pad)
        out.append(tt.reshape((head, n_new ** m) + tail))
    return out


# ----------------------------------------------------------------------------
# TTNO — tree tensor network operator from stacked SoP factors
# ----------------------------------------------------------------------------
def sandwich_env(topo, bra, W, ket, down, i):
    """Three-layer environment of the subtree at node ``i``,
    ``E[Ab, Wp, Ak]`` over its parent bond: <bra|W|ket> contracted over the
    subtree, the children's environments ``down[c]`` given.

    The operand order contracts the child with the widest operator bond
    first, then the node's operator tensor, then the other children, then
    the ket: the largest intermediate holds the bra's child bonds times
    the OTHER children's operator bonds, never the product of all bonds
    (a bra-then-operator order holds D^k w^k at a k-child node)."""
    ch = topo.children[i]
    k = len(ch)
    xb = [0, 3] + [5 + 3 * j for j in range(k)]
    ws = [1, 3, 4] + [6 + 3 * j for j in range(k)]
    xk = [2, 4] + [7 + 3 * j for j in range(k)]
    env = lambda j: [down[ch[j]], [5 + 3 * j, 6 + 3 * j, 7 + 3 * j]]  # noqa
    if k == 0:
        return einsum_chain(bra[i].conj(), xb, W[i], ws, ket[i], xk,
                            [0, 1, 2])
    first = max(range(k), key=lambda j: W[i].shape[3 + j])
    ops = env(first) + [bra[i].conj(), xb, W[i], ws]
    for j in range(k):
        if j != first:
            ops += env(j)
    ops += [ket[i], xk]
    return einsum_chain(*ops, [0, 1, 2])


class TTNO:
    """Tree operator: node tensors (S_p, n, n, S_c1..S_ck) on the device of
    the operator's factors."""

    def __init__(self, topo: TreeTopology, tensors: List[Array]):
        self.topo = topo
        self.tensors = to_tensors(tensors)

    @classmethod
    def from_sop(cls, topo: TreeTopology, op) -> "TTNO":
        """Term-diagonal construction: every edge carries the SoP term index
        with diagonal transfer (node tensors (S, n, n, S, ...))."""
        factors = operator_factors(op)
        assert len(factors) == len(topo), \
            f"operator has {len(factors)} modes, tree has {len(topo)}"
        S = factors[0].shape[0]
        ts = []
        for i, F in enumerate(factors):
            n = F.shape[1]
            k = len(topo.children[i])
            Sp = 1 if i == 0 else S
            if i == 0 and k == 0:       # single node
                ts.append(F.sum(dim=0)[None])
                continue
            W = F.new_zeros((Sp, n, n) + (S,) * k)
            idx = torch.arange(S, device=F.device)
            W[(idx if i else torch.zeros_like(idx), slice(None), slice(None))
              + (idx,) * k] = F
            ts.append(W)
        return cls(topo, ts)

    @classmethod
    def from_sop_compressed(cls, topo: TreeTopology, op,
                            eps: float = 1e-7) -> "TTNO":
        """Bond-COMPRESSED TTNO: per-edge ranks at the operator's tree
        Schmidt ranks instead of the term count (the JAX package's
        construction, Gram-matrix rank reduction bottom-up):

        * per-node term inner products ``P_i[s,s'] = <F_i,s, F_i,s'>``
          (factors Frobenius-normalized per (node, term), the norms folded
          into a per-term weight absorbed at the root);
        * subtree Grams ``G_i = P_i ∘ Π_c G_c``;
        * per edge: ``eigh(G_i)``, keep eigenvalues > (eps²)·λ_max (the
          Gram eigenvalues are squared operator singular values);
          basis ``B_i = U Λ^{1/2}``, dual ``B_i^+ = Λ^{-1/2} U^H``;
        * node tensors ``W_i[b, o, i, b_c...] = Σ_s B_i^+[b,s] F_i,s[o,i]
          Π_c B_c[s, b_c]`` (root: no dual, weights included).

        The rank choice reads each edge's eigenvalues to the host once.
        """
        factors = operator_factors(op)
        L = len(topo)
        assert len(factors) == L, \
            f"operator has {len(factors)} modes, tree has {L}"
        S = factors[0].shape[0]
        cdtype = result_type(*factors)
        dev = factors[0].device

        Fhat: List[Array] = []
        weight = torch.ones(S, dtype=cdtype, device=dev)
        for F in factors:
            F = F.to(cdtype)
            nrm = torch.sqrt(torch.abs((F.conj() * F).sum(dim=(1, 2))))
            nrm = torch.where(nrm > 0, nrm, torch.ones_like(nrm))
            Fhat.append(F / nrm.to(cdtype)[:, None, None])
            weight = weight * nrm.to(cdtype)
        Fhat[0] = Fhat[0] * weight[:, None, None]

        P = [torch.einsum("sij,tij->st", F.conj(), F) for F in Fhat]
        G: List[Optional[Array]] = [None] * L
        B: List[Optional[Array]] = [None] * L
        Bplus: List[Optional[Array]] = [None] * L
        for i in range(L - 1, 0, -1):
            Gi = P[i]
            for c in topo.children[i]:
                Gi = Gi * G[c]
            Gi = (Gi + Gi.conj().T) / 2
            lam, U = torch.linalg.eigh(Gi)
            lam_h = lam.cpu().numpy()
            top = max(float(lam_h[-1]), 0.0)
            if top <= 1e-300:
                # the factors vanish on this whole subtree: a clean rank-1
                # zero bond (inverting a ~0 eigenvalue would poison Bplus)
                B[i] = Gi.new_zeros((S, 1))
                Bplus[i] = Gi.new_zeros((1, S))
                G[i] = torch.zeros_like(Gi)
                continue
            keep = lam_h > eps ** 2 * top
            keep[-1] = True                       # rank >= 1 always
            sel = torch.as_tensor(np.flatnonzero(keep), device=dev)
            lam_k = torch.clamp(lam[sel], min=1e-300)
            U_k = U[:, sel]
            B[i] = U_k * torch.sqrt(lam_k).to(U_k.dtype)[None, :]
            Bplus[i] = (U_k / torch.sqrt(lam_k).to(U_k.dtype)[None, :]
                        ).conj().T
            G[i] = B[i] @ B[i].conj().T

        tensors: List[Array] = []
        for i in range(L):
            ch = topo.children[i]
            if i == 0:
                ops, out = [Fhat[0], [0, 1, 2]], [1, 2]
            else:
                ops, out = [Bplus[i], [9, 0], Fhat[i], [0, 1, 2]], [9, 1, 2]
            for j, c in enumerate(ch):
                ops += [B[c], [0, 10 + j]]
                out.append(10 + j)
            W = einsum_chain(*ops, out)
            tensors.append((W[None] if i == 0 else W).contiguous())
        return cls(topo, tensors)

    @property
    def dtype(self):
        return result_type(*self.tensors)

    @property
    def ranks(self):
        """Edge ranks: the parent-bond dimension of every non-root node."""
        return [int(t.shape[0]) for t in self.tensors[1:]]

    def apply(self, mps: List[Array]) -> List[Array]:
        """Exact TTNO @ TTNS (bond dims multiply; compress afterwards)."""
        out = []
        for W, T in zip(self.tensors, mps):
            dtype = result_type(W, T)
            k = W.ndim - 3               # number of children
            # W (Sp, n', n, Sc..) x T (Dp, n, Dc..) over the ket phys index
            t = torch.tensordot(W.to(dtype), T.to(dtype), dims=([2], [1]))
            # axes now (Sp, n', Sc1..Sck, Dp, Dc1..Dck)
            perm = [0, k + 2, 1]
            for j in range(k):
                perm += [2 + j, k + 3 + j]
            t = t.permute(perm)          # (Sp, Dp, n', Sc1, Dc1, ...)
            shape = (t.shape[0] * t.shape[1], t.shape[2]) + tuple(
                t.shape[3 + 2 * j] * t.shape[4 + 2 * j] for j in range(k))
            out.append(t.reshape(shape))
        return out

    def sandwich(self, bra: List[Array], ket: List[Array]):
        """<bra| H |ket> as a leaf-to-root zipper of (bra, W, ket) (host
        scalar).  The JAX package computes ``vdot(bra, apply(ket))``, the
        same value, but ``apply`` holds (D·w)^k elements at a k-child node:
        (60·24)(60·43)(60·54) ≈ 1.2e10 (96 GB in float64) at the CH3CN
        tree's root for a bond-60 state; the zipper's largest
        intermediate at that node is ~D^3·w^2 (see :func:`sandwich_env`)."""
        L = len(self.topo)
        dtype = result_type(*bra, self.dtype, *ket)
        bra = [t.to(dtype) for t in bra]
        ket = [t.to(dtype) for t in ket]
        W = [t.to(dtype) for t in self.tensors]
        down: List[Optional[Array]] = [None] * L
        for i in range(L - 1, -1, -1):
            down[i] = sandwich_env(self.topo, bra, W, ket, down, i)
        return scalar(down[0][0, 0, 0])


# ----------------------------------------------------------------------------
# the backend class
# ----------------------------------------------------------------------------
class TTNSVector(MPSVector):
    """Tree-tensor-network-state vector (reference: ttnsVector.py role over
    true tree topologies).  Same options plumbing and device placement as
    MPSVector; a chain topology is numerically identical to the MPS
    backend."""

    _supports_als = True   # tree ALS/DMRG sweep engines (ttns_sweeps.py)

    def __init__(self, tensors: List[Array], options: Optional[dict] = None,
                 topo: Optional[TreeTopology] = None, device=None):
        assert topo is not None, "TTNSVector needs a TreeTopology"
        self.topo = topo
        super().__init__(tensors, options, device=device)
        assert len(self.tensors) == len(topo)

    # -- hook overrides ------------------------------------------------------
    def _wrap(self, tensors) -> "TTNSVector":
        return type(self)(tensors, self.options, topo=self.topo)

    def _vdot_t(self, a, b):
        return ttns_vdot(self.topo, a, b)

    def _add_t(self, a, b):
        return ttns_add(self.topo, a, b)

    def _scale_t(self, ts, c):
        return ttns_scale(ts, c)

    def _compress_t(self, ts, maxD=None, eps=0.0):
        return ttns_compress(self.topo, ts, maxD=maxD, eps=eps)

    def _mpo(self, operator):
        if isinstance(operator, TTNO):
            return operator
        cache = getattr(operator, "_ttno_cache", None)
        if cache is None:
            cache = {}
            try:
                operator._ttno_cache = cache
            except Exception:  # pragma: no cover
                pass
        # operator-compression cutoff: compressArgs["operatorEps"]
        # (None/absent = class default)
        eps = self.options.get("compressArgs", {}).get("operatorEps")
        key = (self.topo, eps)
        ttno = cache.get(key)
        if ttno is None:
            kw = {} if eps is None else {"eps": float(eps)}
            ttno = TTNO.from_sop_compressed(self.topo, operator, **kw)
            cache[key] = ttno
        return ttno

    def _als_solve_t(self, mpo, bt, sigma, x0t, sign, **kw):
        """Tree-topology two-site ALS sweep solve (the sweep-engine role the
        reference fills via ttns2 on trees, ttnsVector.py:169-196)."""
        from .ttns_sweeps import tree_als_solve
        return tree_als_solve(self.topo, mpo.tensors, bt, sigma, x0=x0t,
                              sign=sign, **kw)

    # -- constructors / conversions ------------------------------------------
    @classmethod
    def random(cls, topo, dims, maxD, options=None, seed=0, dtype=np.float64,
               device=None):
        v = cls(ttns_random(topo, dims, maxD, seed=seed, dtype=dtype,
                            device=device), options, topo=topo)
        return v.normalize()

    def to_dense(self) -> np.ndarray:
        return ttns_dense(self.topo, self.tensors).cpu().numpy()

    @property
    def maxD(self) -> int:
        return max((t.shape[0] for t in self.tensors[1:]), default=1)

    def to_state_dict(self) -> dict:
        state = {"kind": np.asarray("ttns"),
                 "n_sites": np.asarray(len(self.tensors)),
                 "parents": np.asarray(self.topo.parents)}
        for i, t in enumerate(self.tensors):
            state[f"tensor_{i}"] = t.detach().resolve_conj().cpu().numpy()
        return state

    @classmethod
    def from_state_dict(cls, state, options=None, device=None, topo=None):
        """Rebuild from :meth:`to_state_dict` output (also the JAX
        package's), or from a bare tensor dict with keys ``t0, t1, ...``
        (the production ladders' ``artifacts/ch3cn_tree_*.npz``), which
        carries no topology: pass ``topo``."""
        if "n_sites" in state:
            n = int(state["n_sites"])
            tensors = [state[f"tensor_{i}"] for i in range(n)]
            topo = TreeTopology(tuple(int(p) for p in state["parents"]))
        else:
            if topo is None:
                raise ValueError("a t0, t1, ... state dict needs topo=")
            tensors = [state[f"t{i}"] for i in range(len(topo))]
        return cls([np.asarray(t) for t in tensors], options, topo=topo,
                   device=device)
