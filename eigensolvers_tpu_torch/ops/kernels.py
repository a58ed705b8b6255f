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

import torch

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


def build(name: str, src=None) -> Path:
    """Compile ``csrc/{name}.cu`` (or another version of it, the source
    file ``src``) if not built yet, and return the path of the shared
    library."""
    src = Path(src) if src is not None else CSRC / f"{name}.cu"
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


def launch(fn, device, *args):
    """Call the C entry point ``fn(*args, stream)`` on ``device``'s current
    stream (its raw handle), with ``device`` the current device, where a
    launch goes; returns the launch's CUDA error code.  The raw handle and
    a check of the current device skip the stream object and the device
    context that ``torch.cuda.current_stream()`` and a ``torch.cuda.device``
    block build on every launch: host time that a short row-block launch
    otherwise waits on."""
    index = device.index
    if index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


_P = ctypes.c_void_p
_I = ctypes.c_int


def _load(name: str, signatures: dict, src=None) -> ctypes.CDLL:
    """Build ``csrc/{name}.cu`` (or ``src``, as :func:`build`), load it and
    declare its entry points (``signatures`` maps each to its argument
    types; each returns the CUDA error code of its launch).
    ``lib.error_string`` names the library's ``{name}_error_string``."""
    lib = ctypes.CDLL(str(build(name, src)))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _I
    lib.error_string = getattr(lib, f"{name}_error_string")
    lib.error_string.argtypes = [_I]
    lib.error_string.restype = ctypes.c_char_p
    return lib


_MANY = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]  # nrb, ncb, nbpr, B, m


def load_bsr_spmm(src=None) -> ctypes.CDLL:
    """Build and load ``csrc/bsr_spmm.cu``, or another version of it
    (``src``): for timing versions side by side."""
    return _load("bsr_spmm", {"bsr_spmm_f32": _MANY, "bsr_spmm_f64": _MANY},
                 src)


@functools.cache
def bsr_spmm_library() -> ctypes.CDLL:
    """The block-ELL kernels in f32 and f64 (``csrc/bsr_spmm.cu``: B3, and
    B1 with one vector), built on first call."""
    return load_bsr_spmm()


def load_bsr_spmm_split(src=None) -> ctypes.CDLL:
    """Build and load ``csrc/bsr_spmm_split.cu``, or another version of it
    (``src``): for timing versions side by side."""
    return _load("bsr_spmm_split", {"bsr_spmm_split_f32": [_P, *_MANY]},
                 src)


@functools.cache
def bsr_spmm_split_library() -> ctypes.CDLL:
    """The bf16x3 block-ELL product on the tensor cores
    (``csrc/bsr_spmm_split.cu``: B3 at "high", and B2 with one vector),
    built on first call."""
    return load_bsr_spmm_split()


_ADDRS = ctypes.POINTER(ctypes.c_longlong)
_L = ctypes.c_longlong
_CONTRACT = [_P, _ADDRS, _ADDRS, _I, _I, _L, _L, _I, _L, _I, _I, _P]
# A, B, x, slots, y, S, nslot, Na, Nb, pre, mid, post, m, lane stride, beta,
# launches made
_PAIR = [_P, _P, _P, _ADDRS, _P, _I, _I, _I, _I, _L, _L, _L, _I, _L, _I,
         ctypes.POINTER(_I), _P]


def load_sop_contract(src=None) -> ctypes.CDLL:
    """Build and load ``csrc/sop_contract.cu``, or another version of it
    (``src``): for timing versions side by side."""
    return _load("sop_contract", {"sop_contract_f32": _CONTRACT,
                                  "sop_contract_f64": _CONTRACT,
                                  "sop_pair_f32": _PAIR,
                                  "sop_pair_f64": _PAIR}, src)


@functools.cache
def sop_contract_library() -> ctypes.CDLL:
    """The stacked-factor mode contraction of the grouped sum-of-products
    apply in f32 and f64, one mode a launch and two modes a launch (the
    pair role) (``csrc/sop_contract.cu``), built on first call."""
    return load_sop_contract()


#: Every kernel library, for building them all at once.
LIBRARIES = (bsr_spmm_library, bsr_spmm_split_library, sop_contract_library)


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
