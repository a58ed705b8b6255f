"""Two-mode vibrational Hamiltonian in a direct-product basis, as a
block-sparse operator with an exactly known spectrum.

    H = H_out ⊗ I_B + I_M ⊗ h_in

* outer mode: the first M harmonic-oscillator eigenfunctions (an FBR),
  ``H_out = omega_out (k + 1/2) + lam q^4`` with q the truncated
  tridiagonal position matrix, so q^4 — and H_out — has bandwidth 4;
* inner mode: a B-point ``SincInfInf`` DVR, ``h_in = -1/2 d²/dx² +
  1/2 omega_in² x²``, one dense B×B block.

Ordering the product basis outer-major makes block-row r the outer index
r: block (r, c) is ``H_out[r, c] I_B`` plus ``h_in`` on the diagonal, so a
bandwidth-w outer matrix gives 2w + 1 blocks per block-row.  The spectrum
is the Kronecker sum eig(H_out) ⊕ eig(h_in), from two small host ``eigh``s.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.operators import default_device
from ..ops.sparse import BSROperator
from .bases import Hermite, SincInfInf


def anharmonic_oscillator_fbr(M: int, omega: float, lam: float) -> np.ndarray:
    """H_out = omega (k + 1/2) + lam q^4 in the first M HO eigenfunctions
    (unit mass and frequency for q; bandwidth 4)."""
    basis = Hermite(Hermite.getOptions(N=M, representation="fbr"))
    return omega * np.diag(np.arange(M) + 0.5) + lam * basis.op_q(4)


def sinc_dvr_oscillator(N: int, omega: float, x_range) -> np.ndarray:
    """h_in = -1/2 d²/dx² + 1/2 omega² x² on an N-point sinc DVR."""
    basis = SincInfInf(SincInfInf.getOptions(N=N, xRange=list(x_range)))
    return -0.5 * basis.mat_dx2 + np.diag(0.5 * omega ** 2 * basis.xi ** 2)


def kron_sum_bsr(H_out: np.ndarray, h_in: np.ndarray, bandwidth: int,
                 dtype=torch.float64, device=None,
                 precision="highest") -> BSROperator:
    """The block-ELL operator of ``H_out ⊗ I + I ⊗ h_in``, assembled on
    ``device`` (default: the card; block data never passes through the
    host).  Terms outside the outer matrix (near its edges) are zero
    blocks."""
    device = default_device(device)
    M = H_out.shape[0]
    B = h_in.shape[0]
    w = int(bandwidth)
    if np.any(np.triu(H_out, w + 1)) or np.any(np.tril(H_out, -w - 1)):
        raise ValueError(f"H_out has entries beyond bandwidth {w}")
    rows = np.arange(M)[:, None]
    cols = rows + np.arange(-w, w + 1)[None, :]            # (M, 2w + 1)
    idx = np.clip(cols, 0, M - 1).astype(np.int32)
    coef = np.where((cols >= 0) & (cols < M), H_out[rows, idx], 0.0)
    coef = torch.as_tensor(coef, dtype=dtype, device=device)
    dataT = coef[:, :, None, None] * torch.eye(B, dtype=dtype, device=device)
    dataT[:, w] += torch.as_tensor(h_in.T, dtype=dtype, device=device)
    return BSROperator.from_transposed(dataT, idx, M * B, precision=precision)


def kron_sum_levels(e_out: np.ndarray, e_in: np.ndarray, k: int) -> np.ndarray:
    """The k lowest eigenvalues of H from the sorted factor spectra."""
    k_out = min(k, len(e_out))
    k_in = min(k, len(e_in))
    return np.sort((e_out[:k_out, None] + e_in[None, :k_in]).ravel())[:k]
