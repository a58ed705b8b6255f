"""Typed configuration dataclasses.

The reference's configuration surface is three nested untyped dicts (function
kwargs, the per-vector ``options`` dict, and the ``status`` dict doubling as
input config — SURVEY.md §5 "config/flag system").  These dataclasses give
the same three scopes a typed, validated form while remaining 100%
compatible with the dict surface (``to_options()`` / ``from_options()``
round-trip losslessly, unknown keys riding in ``extra``); every backend
constructor accepts either a raw dict or a :class:`VectorOptions`
(normalized via :func:`normalize_options`), and all solver entry points
continue to accept raw dicts.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field, fields
from typing import Optional


def _split_known(cls, d: dict):
    """Partition a dict into (known dataclass fields, extra)."""
    names = {f.name for f in fields(cls)} - {"extra"}
    known = {k: v for k, v in d.items() if k in names}
    extra = {k: v for k, v in d.items() if k not in names}
    return known, extra


@dataclass
class LinearSystemOptions:
    """Inner shifted-solve options (per-vector scope;
    parity: reference numpyVector.py:31-36 defaults).  Keys outside the
    typed surface (backend-specific sweep controls, ``preconditioner``,
    ``escalateIter``, ...) round-trip through ``extra``."""
    linearSolver: str = "minres"         # minres | gmres/gcrotmk | exact/pardiso
    linearIter: int = 1000
    linear_tol: float = 1e-4
    linear_atol: float = 1e-4
    gmresRestart: int = 30
    errorOnNonConvergence: bool = True
    # compressed backends only:
    maxD: Optional[int] = None
    eps: Optional[float] = None
    extra: dict = field(default_factory=dict)

    def to_options(self) -> dict:
        d = {k: v for k, v in asdict(self).items()
             if v is not None and k != "extra"}
        d.update(self.extra)
        return d

    @classmethod
    def from_options(cls, d: dict) -> "LinearSystemOptions":
        known, extra = _split_known(cls, dict(d))
        return cls(**known, extra=extra)


@dataclass
class CompressOptions:
    """Truncation targets for compressed backends (MPS/TTNS)."""
    maxD: int = 64
    eps: float = 1e-10
    extra: dict = field(default_factory=dict)

    def to_options(self) -> dict:
        d = {k: v for k, v in asdict(self).items() if k != "extra"}
        d.update(self.extra)
        return d

    @classmethod
    def from_options(cls, d: dict) -> "CompressOptions":
        known, extra = _split_known(cls, dict(d))
        return cls(**known, extra=extra)


@dataclass
class VectorOptions:
    """The per-vector options bundle carried by every backend vector.
    Accepted directly by every backend constructor in place of the raw
    options dict (normalized through :func:`normalize_options`)."""
    linearSystemArgs: LinearSystemOptions = field(
        default_factory=LinearSystemOptions)
    compressArgs: Optional[CompressOptions] = None
    orthogonalizationArgs: Optional[CompressOptions] = None
    stateFittingArgs: Optional[CompressOptions] = None
    extra: dict = field(default_factory=dict)

    def to_options(self) -> dict:
        out = {"linearSystemArgs": self.linearSystemArgs.to_options()}
        for name in ("compressArgs", "orthogonalizationArgs",
                     "stateFittingArgs"):
            v = getattr(self, name)
            if v is not None:
                out[name] = v.to_options()
        out.update(self.extra)
        return out

    @classmethod
    def from_options(cls, d: dict) -> "VectorOptions":
        d = dict(d)
        ls = LinearSystemOptions.from_options(d.pop("linearSystemArgs", {}))
        kw = {}
        for name in ("compressArgs", "orthogonalizationArgs",
                     "stateFittingArgs"):
            if name in d:
                kw[name] = CompressOptions.from_options(d.pop(name))
        return cls(linearSystemArgs=ls, extra=d, **kw)


def normalize_options(options):
    """Backend-constructor seam: accept ``None``, a raw options dict, or a
    typed :class:`VectorOptions` (anything with ``to_options``) and return
    the dict form the solvers consume."""
    if options is None:
        return {}
    to = getattr(options, "to_options", None)
    if callable(to):
        return to()
    return dict(options)


@dataclass
class LanczosConfig:
    """Entry-point scope for inexact Lanczos
    (parity: reference inexact_Lanczos.py:229-235 kwargs)."""
    sigma: float = 0.0
    L: int = 10
    maxit: int = 20
    eConv: float = 1e-6
    checkFitTol: float = 1e-7
    writeOut: bool = True
    eShift: float = 0.0
    convertUnit: str = "au"
    outFileName: Optional[str] = None
    summaryFileName: Optional[str] = None
    saveEachIteration: bool = False
    saveDir: str = "saveKrylov"
    batchBlockSolves: bool = True
    thickRestart: bool = True

    def run(self, H, v0, pick=None, status=None, Hsolve=None):
        from .solvers.lanczos import inexactLanczosDiagonalization
        kw = asdict(self)
        sigma = kw.pop("sigma")
        L = kw.pop("L")
        maxit = kw.pop("maxit")
        eConv = kw.pop("eConv")
        return inexactLanczosDiagonalization(
            H, v0, sigma, L, maxit, eConv, pick=pick, status=status,
            Hsolve=Hsolve, **kw)


@dataclass
class FeastConfig:
    """Entry-point scope for FEAST (parity: reference feast.py:126-129)."""
    nc: int = 8
    quad: str = "legendre"
    eMin: float = 0.0
    eMax: float = 1.0
    eConv: float = 1e-6
    maxit: int = 20
    contourEllipseFactor: float = 1.0
    writeOut: bool = True
    eShift: float = 0.0
    convertUnit: str = "au"
    outFileName: Optional[str] = None
    summaryFileName: Optional[str] = None
    batchQuadratureSolves: bool = True

    def run(self, A, Y, status=None):
        from .solvers.feast import feastDiagonalization
        kw = asdict(self)
        args = [kw.pop(k) for k in ("nc", "quad", "eMin", "eMax", "eConv",
                                    "maxit")]
        return feastDiagonalization(A, Y, *args, status=status, **kw)
