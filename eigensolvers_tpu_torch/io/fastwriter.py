"""ctypes binding for the native async checkpoint writer
(``csrc/fastio.cpp``, host C++, no CUDA).

The shared library is compiled with ``g++`` on first use (never at import)
into the package's build directory, ``<repo>/build/eigensolvers_tpu_torch/``
(the one the CUDA kernels use), under a name that carries a hash of the
source and the flags.  Where no compiler is available ``AsyncWriter`` falls
back to synchronous Python writes (``AsyncWriter.available`` is False).
"""

from __future__ import annotations

import ctypes
import hashlib
import io as _io
import os
import subprocess
import threading

import numpy as np

from ..ops.kernels import BUILD_DIR, CSRC

_SRC = CSRC / "fastio.cpp"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-pthread")
_build_lock = threading.Lock()
_lib_handle = None
_build_failed = False


def library_path():
    """Where the built library goes: keyed by the source and the flags."""
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libfastio_{digest}.so"


def build():
    """Compile ``csrc/fastio.cpp`` with g++ if not built yet; returns the
    library's path (raises if g++ fails)."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                           f"{_SRC}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)       # atomic: concurrent builders never see a stub
    return lib


def _load_library():
    """Compile (if needed) and dlopen the native library; None on failure."""
    global _lib_handle, _build_failed
    if _lib_handle is not None:
        return _lib_handle
    if _build_failed:
        return None
    with _build_lock:
        if _lib_handle is not None:
            return _lib_handle
        try:
            lib = ctypes.CDLL(str(build()))
            lib.fio_create.restype = ctypes.c_void_p
            lib.fio_create.argtypes = [ctypes.c_int]
            lib.fio_submit.restype = ctypes.c_int
            lib.fio_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_void_p, ctypes.c_long]
            lib.fio_pending.restype = ctypes.c_int
            lib.fio_pending.argtypes = [ctypes.c_void_p]
            lib.fio_flush.restype = ctypes.c_int
            lib.fio_flush.argtypes = [ctypes.c_void_p]
            lib.fio_error_count.restype = ctypes.c_int
            lib.fio_error_count.argtypes = [ctypes.c_void_p]
            lib.fio_destroy.restype = None
            lib.fio_destroy.argtypes = [ctypes.c_void_p]
            _lib_handle = lib
        except Exception:
            _build_failed = True
            return None
    return _lib_handle


class AsyncWriter:
    """Asynchronous file writer: ``submit`` enqueues bytes for a background
    native thread, ``flush`` blocks until everything is durably renamed into
    place (writes go to ``path.tmp`` then rename — no torn checkpoints).

    Falls back to synchronous writes when the native library is unavailable
    (``self.available`` is False then).  ``submitted`` counts the jobs the
    native thread took.
    """

    def __init__(self, max_queue: int = 16):
        self._lib = _load_library()
        self._h = None
        self.submitted = 0
        if self._lib is not None:
            h = self._lib.fio_create(int(max_queue))
            self._h = ctypes.c_void_p(h) if h else None
        self.available = self._h is not None

    def submit_bytes(self, path: str, data: bytes) -> None:
        if self.available:
            rc = self._lib.fio_submit(self._h, path.encode(), data, len(data))
            if rc == 0:
                self.submitted += 1
                return
        # fallback: synchronous atomic write
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(data)
        os.replace(tmp, path)

    def submit_npz(self, path: str, **arrays) -> None:
        """Serialize arrays npz-style in memory, then enqueue the bytes."""
        buf = _io.BytesIO()
        np.savez(buf, **arrays)
        self.submit_bytes(path, buf.getvalue())

    def pending(self) -> int:
        if not self.available:
            return 0
        return int(self._lib.fio_pending(self._h))

    def flush(self) -> int:
        """Block until all submitted writes completed; returns error count."""
        if not self.available:
            return 0
        return int(self._lib.fio_flush(self._h))

    def close(self) -> None:
        if self._h is not None:
            self._lib.fio_flush(self._h)
            self._lib.fio_destroy(self._h)
            self._h = None
            self.available = False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
