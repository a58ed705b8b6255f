"""Molecular vibrational / vibronic Hamiltonians from the bundled MCTDH
operator files (this package's own copies, ``models/data/``).

Problem parity:
  * pyrazine 4-mode vibronic model (pyr4+.op; Raab, Worth, Meyer, Cederbaum
    JCP 110, 936 (1999)) — electronic 2-state mode + 4 normal modes
    (reference unittests/test_feast_ttns.py:27-41 uses it with per-mode
    basis cuts controlled by a FAC parameter);
  * CH3CN 12-mode Hamiltonian (ch3cn.op; Avila & Carrington JCP 134, 054126
    (2011)) — the production-scale configuration (N=42 per mode,
    reference examples/ttns2_ch3cn.py:25-34).

Modes use harmonic-oscillator bases in dimensionless normal coordinates;
the electronic mode is a discrete 2-state basis.  ``ch3cn_tree`` and
``ch3cn_tree_operator`` give the CH3CN Hamiltonian on the production tree
layout of the tree tensor-network backend.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from .bases import Electronic, Hermite
from .op_parser import build_sop_operator, parse_op_file

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")
PYR4_OP = os.path.join(DATA_DIR, "pyr4+.op")
CH3CN_OP = os.path.join(DATA_DIR, "ch3cn.op")


def pyrazine4_operator(N: int = 6, nel: int = 2, dtype=np.float64,
                       term_chunk: Optional[int] = None,
                       fuse: Optional[int] = None, device=None):
    """Pyrazine 4-mode vibronic SoP operator.

    :param N: HO-DVR points per vibrational mode (N=4..6 gives a
        dense-feasible cut: dim = 2*N^4)
    :param device: where the factors go (default: the card)
    :returns: (GroupedSoPOperator, OpSpec, bases)
    """
    spec = parse_op_file(PYR4_OP)
    # FBR (HO eigenbasis) matrices: the right discretization for polynomial
    # vibronic force fields (see Hermite docstring)
    bases = [Electronic({"N": nel})] + \
        [Hermite(Hermite.getOptions(N=N, representation="fbr"))
         for _ in range(4)]
    op = build_sop_operator(spec, bases, dtype=dtype, term_chunk=term_chunk,
                            fuse=fuse, device=device)
    return op, spec, bases


def ch3cn_operator(N: int = 42, nModesCut: Optional[int] = None,
                   dtype=np.float64, term_chunk: Optional[int] = None,
                   fuse: Optional[int] = None, representation: str = "fbr",
                   device=None):
    """CH3CN 12-mode Hamiltonian SoP operator.

    :param N: HO-basis functions / DVR points per mode (production: 42; use
        small N and/or ``nModesCut`` for dense-feasible testing)
    :param nModesCut: keep only the first k modes (terms touching dropped
        modes are removed) — a controlled truncation for testing
    :param representation: "fbr" (default — truncated HO-basis matrices,
        quadrature-exact polynomial integrals, immune to the polynomial PES
        turnover) or "dvr" (Gauss-Hermite grid).  At N=42 the DVR grid
        reaches the PES turnover region and the operator has collapsed
        negative-energy states (measured: DMRG falls to -5.5e5 cm-1,
        artifacts/ch3cn_production.jsonl "representation" rung) — the FBR
        production ZPVE (9837.479) is the quadrature-exact value for this
        PES; the reference's DVR-based 9837.4069 sits 0.07 cm-1 below it
        (see examples/ch3cn_representation_2mode.py for the dense-feasible
        quantification of the representation offset)
    :param device: where the factors go (default: the card)
    :returns: (GroupedSoPOperator, OpSpec, bases)
    """
    spec = parse_op_file(CH3CN_OP)
    if nModesCut is not None and nModesCut < spec.nModes:
        spec.terms = [t for t in spec.terms
                      if all(d < nModesCut for d in t.factors)]
        spec.mode_labels = spec.mode_labels[:nModesCut]
    bases = [Hermite(Hermite.getOptions(N=N, representation=representation))
             for _ in range(spec.nModes)]
    op = build_sop_operator(spec, bases, dtype=dtype, term_chunk=term_chunk,
                            fuse=fuse, device=device)
    return op, spec, bases


def ch3cn_tree():
    """The reference's production CH3CN tree layout
    (reference: examples/ttns2_ch3cn_Block.py:62-76 — a 3-branch tree with
    fused 2-mode leaves and coordinate-free internal nodes, here mapped
    onto the one-(super-)mode-per-node tree backend with dim-1 virtual
    nodes).  Mode indices are 0-based (x1..x12 -> 0..11).

    :returns: (TreeTopology, parts) — pass ``parts`` as
        ``build_sop_operator(mode_parts=...)`` / use ``ch3cn_tree_operator``.
    """
    from ..vectors.ttns import tree_layout
    layout = ([], [
        ([], [([0], []),
              ([4, 5], [])]),
        ([], [([6, 7], []),
              ([8, 9], [])]),
        ([], [([], [([2], []),
                    ([], [([1], []),
                          ([3], [])])]),
              ([], [([10, 11], [])])]),
    ])
    return tree_layout(layout)


def ch3cn_tree_operator(N: int = 42, dtype=np.float64, device=None):
    """CH3CN operator regrouped onto the production tree layout.

    :param device: where the factors go (default: the card)
    :returns: (GroupedSoPOperator over the tree's node dims, TreeTopology,
        parts, bases)
    """
    spec = parse_op_file(CH3CN_OP)
    topo, parts = ch3cn_tree()
    bases = [Hermite(Hermite.getOptions(N=N, representation="fbr"))
             for _ in range(spec.nModes)]
    op = build_sop_operator(spec, bases, dtype=dtype, mode_parts=parts,
                            device=device)
    return op, topo, parts, bases
