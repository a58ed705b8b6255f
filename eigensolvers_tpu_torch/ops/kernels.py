"""Build and load the package's hand-written CUDA kernels (``csrc/``).

Each ``.cu`` file is compiled with ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, loaded with :mod:`ctypes`.  The
build happens on first use, never at import, into
``<repo>/build/eigensolvers_tpu_torch/``; the library's file name carries a
hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "eigensolvers_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else
    ``/usr/local/cuda/bin/nvcc``, else ``nvcc`` on the PATH."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found in $CUDA_HOME/bin, /usr/local/cuda/bin or PATH: "
            "the CUDA kernels need the CUDA toolkit")
    return found


def build(name: str) -> Path:
    """Compile ``csrc/{name}.cu`` (if not built yet) and return the path of
    the shared library."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {src}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)       # atomic: concurrent builders never see a stub
    return lib


_P = ctypes.c_void_p
_I = ctypes.c_int


def _load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build ``csrc/{name}.cu``, load it and declare its entry points
    (``signatures`` maps each to its argument types; each returns the CUDA
    error code of its launch).  ``lib.error_string`` names the library's
    ``{name}_error_string``."""
    lib = ctypes.CDLL(str(build(name)))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _I
    lib.error_string = getattr(lib, f"{name}_error_string")
    lib.error_string.argtypes = [_I]
    lib.error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def bsr_spmv_library() -> ctypes.CDLL:
    """The single-vector block-ELL SpMV kernels (``csrc/bsr_spmv.cu``, B1
    and B2), built on first call."""
    one = [_P, _P, _P, _P, _I, _I, _I, _P]
    return _load("bsr_spmv", {"bsr_spmv_f32": one, "bsr_spmv_f64": one,
                              "bsr_spmv_split_f32": [_P, *one]})


@functools.cache
def bsr_spmm_library() -> ctypes.CDLL:
    """The multi-vector block-ELL kernels (``csrc/bsr_spmm.cu``, B3), built
    on first call."""
    many = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
    return _load("bsr_spmm", {"bsr_spmm_f32": many, "bsr_spmm_f64": many,
                              "bsr_spmm_split_f32": [_P, *many]})


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
