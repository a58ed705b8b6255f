"""ch3cn6: the plain reference.  Plain numpy and torch only: it imports
nothing of the port, of JAX or of the JAX package.  It parses the
configuration's own copy of the MCTDH ``.op`` file (a frozen copy of the
port's ``models/op_parser.py`` grammar for this file: parameters with
units, ``|mode op`` factors, op in {KE, dq^2, q, q^n}), builds each mode's
harmonic-oscillator FBR matrices (q^k the k-th power of the truncated
tridiagonal q; d2/dq2 exact in the truncated basis) and applies H term by
term, mode by mode.

Its levels: the lowest levels of H by dense ``eigh`` where n <= 4,096 (the
tests' sizes), else from ``ch3cn6_levels.json``, which this module's
``__main__`` writes on the card (``lowest_levels``, ``largest_magnitude``)::

    python -m benchmark.configs.ch3cn6_ref [--N N]   (from the repo's root)
"""

import json
import re
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
LEVELS_FILE = HERE / "ch3cn6_levels.json"
# 1 hartree in cm-1 (2018 CODATA)
AU_TO = {"au": 1.0, "hartree": 1.0, "cm-1": 219474.6313632,
         "ev": 27.211386245988}
DENSE_MAX = 4096


def parse(path):
    """(parameters in hartree, mode labels, [(coeff, {mode: label})])."""
    params, modes, terms = {}, [], []
    section = None
    for raw in Path(path).read_text().splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        low = line.lower()
        if low.startswith("parameter-section"):
            section = "param"
            continue
        if low.startswith("hamiltonian-section"):
            section = "ham"
            continue
        if low.startswith("end-") and not low.startswith("end-title"):
            section = None
            continue
        if section == "param" and "=" in line:
            name, rhs = (s.strip() for s in line.split("=", 1))
            if "," in rhs:
                val, unit = rhs.split(",", 1)
                params[name] = float(val) / AU_TO[unit.strip().lower()]
            else:
                params[name] = float(rhs)
        elif section == "ham":
            if set(line) <= {"-"}:
                continue
            if low.startswith("modes"):
                modes += [c.strip() for c in line.split("|")[1:] if c.strip()]
                continue
            if "|" not in line:
                continue
            head, *facs = line.split("|")
            coeff, expr = 1.0, head.strip()
            while expr and expr[0] in "+-":
                coeff = -coeff if expr[0] == "-" else coeff
                expr = expr[1:].strip()
            for tok in filter(None, (t.strip() for t in expr.split("*"))):
                try:
                    coeff *= float(tok)
                except ValueError:
                    coeff *= params[tok]
            factors = {}
            for f in filter(None, (f.strip() for f in facs)):
                m = re.match(r"^(\d+)\s+(\S+)$", f)
                mode, label = int(m.group(1)) - 1, m.group(2)
                factors[mode] = (factors[mode] + "*" + label
                                 if mode in factors else label)
            terms.append((coeff, factors))
    return params, modes, terms


def ho_matrices(N):
    """The FBR matrices of one mode in its first N harmonic-oscillator
    functions: q (tridiagonal) and d2/dq2 = <m|q^2|n> - diag(2n + 1)."""
    k = np.arange(N - 1)
    q = np.zeros((N, N))
    q[k, k + 1] = q[k + 1, k] = np.sqrt((k + 1) / 2.0)
    n = np.arange(N)
    q2 = np.diag((2.0 * n + 1.0) / 2.0)
    j = np.arange(N - 2)
    q2[j, j + 2] = q2[j + 2, j] = np.sqrt((j + 1.0) * (j + 2.0)) / 2.0
    return q, q2 - np.diag(2.0 * n + 1.0)


def factor(label, q, d2):
    if "*" in label:
        out = np.eye(len(q))
        for part in label.split("*"):
            out = out @ factor(part, q, d2)
        return out
    if label in ("1", "I", "unit"):
        return np.eye(len(q))
    if label == "KE":
        return -0.5 * d2
    if label == "dq^2":
        return d2
    m = re.match(r"^q(\^(\d+))?$", label)
    if m is None:
        raise ValueError(f"unknown operator label {label!r}")
    return np.linalg.matrix_power(q, int(m.group(2) or 1))


def cut_terms(op_file, nModes):
    """The .op file's terms that touch only the first ``nModes`` modes,
    and its parameters."""
    params, _, terms = parse(op_file)
    return params, [(c, f) for c, f in terms if all(d < nModes for d in f)]


class Reference:
    def __init__(self, op_file, nModes, N, device, with_levels=True):
        self.N, self.nModes = N, nModes
        self.dims = (N,) * nModes
        self.n = N ** nModes
        _, terms = cut_terms(op_file, nModes)
        q, d2 = ho_matrices(N)
        self.terms = [(c, [(d, torch.as_tensor(factor(l, q, d2),
                                               dtype=torch.float64,
                                               device=device))
                           for d, l in sorted(f.items())])
                      for c, f in terms]
        self.device = device
        if with_levels:
            self._levels, self.h_norm = self._reference_levels()

    def apply(self, V, dtype=torch.float64):
        """H V for the rows of V (m, n), every product in ``dtype``."""
        X = V.to(dtype).reshape((-1,) + self.dims)
        Y = torch.zeros_like(X)
        for c, facs in self.terms:
            Z = X
            for d, F in facs:
                Z = torch.movedim(torch.movedim(Z, d + 1, -1) @ F.to(dtype).T,
                                  -1, d + 1)
            Y += c * Z
        return Y.reshape(V.shape)

    def levels(self, count=None):
        """The ``count`` lowest levels (default: all kept), ascending."""
        count = len(self._levels) if count is None else count
        if count > len(self._levels):
            raise ValueError(f"{count} levels asked, {len(self._levels)} kept")
        return np.asarray(self._levels[:count])

    def _reference_levels(self):
        if self.n <= DENSE_MAX:
            eye = torch.eye(self.n, dtype=torch.float64, device=self.device)
            H = self.apply(eye)
            e = torch.linalg.eigvalsh(0.5 * (H + H.T)).cpu().numpy()
            return e[:8], float(max(abs(e[0]), abs(e[-1])))
        rec = json.loads(LEVELS_FILE.read_text())
        key = f"nModes={self.nModes},N={self.N}"
        if key not in rec:
            raise KeyError(f"no reference levels for {key} in "
                           f"{LEVELS_FILE.name}; write them with its "
                           f"__main__ on the card")
        return rec[key]["levels"], rec[key]["h_norm"]



def lowest_levels(apply, n, count, device, m=40, keep=None, tol=1e-12,
                  max_applies=20000, seed=0):
    """The ``count`` lowest eigenvalues of the symmetric operator ``apply``
    in f64 by thick-restart Lanczos with full reorthogonalization: a basis
    V of at most ``m`` orthonormal vectors and W = H V kept on ``device``;
    Rayleigh-Ritz on V.W^T; restarted from the ``keep`` lowest Ritz
    vectors and the next Krylov direction; done once each of the ``count``
    lowest Ritz pairs has a true residual ||H y - theta y|| (from W) below
    ``tol``.  Returns (levels, residuals, applies)."""
    keep = keep or count + 8
    gen = torch.Generator(device=device).manual_seed(seed)
    V = torch.empty((m, n), dtype=torch.float64, device=device)
    W = torch.empty_like(V)
    nxt = torch.randn(n, generator=gen, dtype=torch.float64, device=device)
    nxt /= torch.linalg.vector_norm(nxt)
    size = applies = 0
    while applies < max_applies:
        while size < m:
            V[size] = nxt
            W[size] = apply(nxt[None])[0]
            applies += 1
            size += 1
            w = W[size - 1].clone()
            for _ in range(2):
                w -= V[:size].T @ (V[:size] @ w)
            nxt = w / torch.linalg.vector_norm(w)
        G = V @ W.T
        theta, S = torch.linalg.eigh(0.5 * (G + G.T))
        Sk = S[:, :keep].T.contiguous()
        Y, HY = Sk @ V, Sk @ W
        res = torch.linalg.vector_norm(HY[:count] - theta[:count, None]
                                       * Y[:count], dim=1)
        if bool((res < tol).all()):
            return (theta[:count].cpu().numpy(), res.cpu().numpy(),
                    applies)
        V[:keep], W[:keep] = Y, HY
        size = keep
    raise RuntimeError(f"no convergence in {max_applies} applies "
                       f"(residuals {res.tolist()})")


def largest_magnitude(apply, n, device, steps=300, seed=1):
    """max |eigenvalue| of ``apply``: the extreme Ritz values of a plain
    Lanczos run of ``steps`` steps (the ends of the spectrum converge
    first; a Ritz value never lies outside it)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    v = torch.randn(n, generator=gen, dtype=torch.float64, device=device)
    v /= torch.linalg.vector_norm(v)
    v_prev, alpha, beta = torch.zeros_like(v), [], []
    for k in range(steps):
        w = apply(v[None])[0]
        alpha.append(float(v @ w))
        w -= alpha[-1] * v + (beta[-1] * v_prev if k else 0.0)
        beta.append(float(torch.linalg.vector_norm(w)))
        v_prev, v = v, w / beta[-1]
    theta = np.linalg.eigvalsh(np.diag(alpha) + np.diag(beta[:-1], 1)
                               + np.diag(beta[:-1], -1))
    return float(max(abs(theta[0]), abs(theta[-1])))


def main(argv=None):
    """Write the reference levels of the configuration as it is run, or at
    ``--N``."""
    import argparse
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--N", type=int)
    cfg = json.loads((HERE / "ch3cn6.json").read_text())
    cfg["N"] = ap.parse_args(argv).N or cfg["N"]
    device = torch.device("cuda")
    ref = Reference(HERE.parents[1] / cfg["op_file"], cfg["nModes"],
                    cfg["N"], device, with_levels=False)
    levels, res, applies = lowest_levels(ref.apply, ref.n, 4, device)
    h_norm = largest_magnitude(ref.apply, ref.n, device)
    rec = json.loads(LEVELS_FILE.read_text()) if LEVELS_FILE.exists() else {}
    rec[f"nModes={ref.nModes},N={ref.N}"] = {
        "levels": [float(e) for e in levels], "h_norm": h_norm,
        "how": f"thick-restart Lanczos in f64 with full "
               f"reorthogonalization from a random start, {applies} applies, "
               f"residuals "
               f"{', '.join(f'{r:.1e}' for r in res)} hartree",
        "device": torch.cuda.get_device_name(0)}
    LEVELS_FILE.write_text(json.dumps(rec, indent=1) + "\n")
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
