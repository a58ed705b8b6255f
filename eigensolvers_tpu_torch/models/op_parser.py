"""MCTDH-format ``.op`` operator file parser → sum-of-products operators.

A copy of the JAX package's ``models/op_parser.py`` building this package's
operators (the role of the reference's external
``mctdh_stuff.translateOperatorFile``), for the subset of the MCTDH grammar
the bundled operator files exercise (``models/data/{pyr4+,ch3cn}.op``):

* ``OP_DEFINE-SECTION`` (title only),
* ``PARAMETER-SECTION``: ``name = value [, unit]`` with units converted to
  hartree (ev, cm-1, au),
* ``HAMILTONIAN-SECTION``: a ``modes | m1 | m2 ...`` header naming the mode
  columns, then one term per line: ``coeff-expr  |i op  [|j op ...]`` where
  ``coeff-expr`` is a '*'-product of numbers and parameter names with an
  optional sign, and ``op`` ∈ {KE, dq^2, q, q^n, S<i>&<j>, 1}.

Factor conventions (MCTDH): ``KE`` = -1/2 d²/dq²; ``dq^2`` = d²/dq²;
``q^n`` = position to the n-th power (diagonal in a DVR); ``S<i>&<j>`` =
|i><j| + |j><i| for i≠j, |i><i| otherwise (electronic-mode projector).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.operators import (GroupedSoPOperator, SumOfProductOperator,
                             fuse_parts, fuse_sop_terms, regroup_sop_terms)
from ..utils.profiling import spanned
from ..utils.units import unit2au
from .bases import BasisBase, Electronic


@dataclass
class OpTerm:
    """One sum-of-products term: coeff × ∏_d factor_d (symbolic labels)."""
    coeff: float
    factors: Dict[int, str] = field(default_factory=dict)  # mode idx (0-based) → label


@dataclass
class OpSpec:
    """Parsed content of an .op file."""
    title: str
    parameters: Dict[str, float]          # in hartree (energies) / raw
    mode_labels: List[str]
    terms: List[OpTerm]

    @property
    def nModes(self) -> int:
        return len(self.mode_labels)


def _strip_comment(line: str) -> str:
    pos = line.find("#")
    return line if pos < 0 else line[:pos]


def _parse_parameter(line: str) -> Optional[Tuple[str, float]]:
    if "=" not in line:
        return None
    name, rhs = line.split("=", 1)
    name = name.strip()
    rhs = rhs.strip()
    if "," in rhs:
        val, unit = rhs.split(",", 1)
        value = float(unit2au(float(val), unit.strip()))
    else:
        value = float(rhs)
    return name, value


def _eval_coeff(expr: str, params: Dict[str, float]) -> float:
    """Evaluate a '*'-product of numbers and parameter names with optional
    leading sign; no arbitrary eval."""
    expr = expr.strip()
    sign = 1.0
    while expr and expr[0] in "+-":
        if expr[0] == "-":
            sign = -sign
        expr = expr[1:].strip()
    value = sign
    for tok in expr.split("*"):
        tok = tok.strip()
        if not tok:
            continue
        try:
            value *= float(tok)
        except ValueError:
            if tok not in params:
                raise KeyError(f"unknown parameter {tok!r} in coefficient {expr!r}")
            value *= params[tok]
    return value


@spanned("es.parse")
def parse_op_file(path: str) -> OpSpec:
    """Parse an MCTDH .op file into an :class:`OpSpec`."""
    with open(path) as fh:
        raw_lines = fh.read().splitlines()

    title = ""
    params: Dict[str, float] = {}
    mode_labels: List[str] = []
    terms: List[OpTerm] = []

    section = None
    in_title = False
    for raw in raw_lines:
        line = _strip_comment(raw).strip()
        if not line:
            continue
        low = line.lower()

        if low.startswith("op_define-section"):
            section = "define"
            continue
        if low.startswith("parameter-section"):
            section = "param"
            continue
        if low.startswith("hamiltonian-section"):
            section = "ham"
            continue
        if low.startswith("end-"):
            if low.startswith("end-title"):
                in_title = False
            else:
                section = None
            continue

        if section == "define":
            if low == "title":
                in_title = True
            elif in_title:
                title = (title + " " + line).strip()
            continue

        if section == "param":
            kv = _parse_parameter(line)
            if kv is not None:
                params[kv[0]] = kv[1]
            continue

        if section == "ham":
            if set(line) <= {"-"}:
                continue  # ruler lines
            if low.startswith("modes"):
                cells = [c.strip() for c in line.split("|")[1:]]
                mode_labels.extend(c for c in cells if c)
                continue
            if "|" not in line:
                continue
            head, *facs = line.split("|")
            coeff = _eval_coeff(head, params)
            factors: Dict[int, str] = {}
            for f in facs:
                f = f.strip()
                if not f:
                    continue
                m = re.match(r"^(\d+)\s+(\S+)$", f)
                if m is None:
                    raise ValueError(f"cannot parse factor {f!r} in line {raw!r}")
                mode = int(m.group(1)) - 1           # MCTDH columns are 1-based
                label = m.group(2)
                if mode in factors:
                    # repeated mode in one term → compose labels
                    factors[mode] = factors[mode] + "*" + label
                else:
                    factors[mode] = label
            terms.append(OpTerm(coeff=coeff, factors=factors))
            continue

    if not mode_labels:
        raise ValueError(f"no 'modes' line found in {path}")
    return OpSpec(title=title, parameters=params, mode_labels=mode_labels,
                  terms=terms)


def _factor_matrix(label: str, basis: BasisBase) -> np.ndarray:
    """Matrix for a single-mode operator label on ``basis``."""
    if "*" in label:
        mats = [_factor_matrix(p, basis) for p in label.split("*")]
        out = mats[0]
        for m in mats[1:]:
            out = out @ m
        return out
    if label in ("1", "I", "unit"):
        return basis.op_identity()
    if label == "KE":
        return basis.op_ke()
    if label == "dq^2":
        return basis.op_dx2()
    m = re.match(r"^q(\^(\d+))?$", label)
    if m:
        return basis.op_q(int(m.group(2)) if m.group(2) else 1)
    m = re.match(r"^S(\d+)&(\d+)$", label)
    if m:
        if not isinstance(basis, Electronic):
            raise ValueError(f"S{m.group(1)}&{m.group(2)} requires an "
                             f"electronic basis")
        return basis.op_S(int(m.group(1)), int(m.group(2)))
    raise ValueError(f"unknown operator label {label!r}")


@spanned("es.build")
def build_sop_operator(spec: OpSpec, bases: Sequence[BasisBase],
                       dtype=np.float64,
                       term_chunk: Optional[int] = None,
                       group_by_support: bool = True,
                       fuse: Optional[int] = None,
                       mode_parts: Optional[Sequence] = None,
                       device=None):
    """Materialize the parsed spec as a sum-of-products operator over the
    given per-mode bases (order matching ``spec.mode_labels``).

    By default terms are grouped by their active-mode support
    (:class:`GroupedSoPOperator`) so identity factors are never applied —
    a several-fold FLOP saving for the molecular Hamiltonians; pass
    ``group_by_support=False`` for the plain stacked form.

    ``fuse`` (a target dimension, e.g. 256) coarsens the mode grid by
    Kronecker-fusing consecutive modes into TPU-tile-sized super-modes
    before grouping (see
    :func:`~eigensolvers_tpu_torch.ops.operators.fuse_sop_terms`); the
    grouped operator keeps the physical factors of its groups that span
    several super-modes, and applies them mode by mode (see
    :class:`~eigensolvers_tpu_torch.ops.operators.GroupedSoPOperator`).
    Leave unset for tensor-network backends, whose site dimensions must
    stay physical.  ``device`` places the factors (default: the card).  The
    span ``es.build`` times it, the uploads to the card included (one
    synchronize of the card at the end)."""
    if len(bases) != spec.nModes:
        raise ValueError(f"need {spec.nModes} bases ({spec.mode_labels}), "
                         f"got {len(bases)}")
    dims = [b.N for b in bases]
    term_list = []
    for t in spec.terms:
        facs = {d: np.asarray(_factor_matrix(lbl, bases[d]), dtype=dtype)
                for d, lbl in t.factors.items()}
        term_list.append((t.coeff, facs))
    if mode_parts is not None:
        # arbitrary-partition regrouping (tree layouts with multi-mode
        # leaves and dim-1 virtual nodes; see regroup_sop_terms)
        if fuse:
            raise ValueError("fuse and mode_parts are mutually exclusive")
        dims, term_list = regroup_sop_terms(dims, term_list, mode_parts)
        term_list = [(c, {d: np.asarray(m, dtype=dtype)
                          for d, m in facs.items()})
                     for c, facs in term_list]
    elif fuse and not group_by_support:
        dims, term_list, _ = fuse_sop_terms(dims, term_list, target=fuse)
        term_list = [(c, {d: np.asarray(m, dtype=dtype)
                          for d, m in facs.items()})
                     for c, facs in term_list]
    if group_by_support:
        op = GroupedSoPOperator.from_terms(
            nDim=len(dims), dims=dims, terms=term_list, dtype=dtype,
            device=device, parts=fuse_parts(dims, fuse) if fuse else None)
    else:
        op = SumOfProductOperator.from_terms(
            nDim=len(dims), dims=dims, terms=term_list, dtype=dtype,
            term_chunk=term_chunk, device=device)
    t = next(op.buffers(), None)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)
    return op


def translateOperatorFile(path: str, bases: Sequence[BasisBase],
                          dtype=np.float64,
                          term_chunk: Optional[int] = None, device=None):
    """Parity-named convenience wrapper (reference call sites use
    ``mctdh_stuff.translateOperatorFile``): parse + build in one call.

    :returns: (GroupedSoPOperator, OpSpec)
    """
    spec = parse_op_file(path)
    return build_sop_operator(spec, bases, dtype=dtype,
                              term_chunk=term_chunk, device=device), spec
