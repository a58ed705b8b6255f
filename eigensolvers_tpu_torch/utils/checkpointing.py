"""Backend-neutral checkpoint / resume for Krylov bases.

The reference only *writes* TTNS snapshots, unconditionally calling ``.ttns``
so its default crashes the dense backend, and has no resume path
(reference: inexact_Lanczos.py:383-393; SURVEY.md §5 "checkpoint/resume").
Here checkpointing is opt-in, works for every backend implementing
``to_state_dict``/``from_state_dict``, and round-trips: a saved basis can be
reloaded as guess vectors (true resume).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np


_DEFAULT_WRITER = None
_DEFAULT_WRITER_TRIED = False


def default_async_writer():
    """Process-shared :class:`~eigensolvers_tpu_torch.io.fastwriter.AsyncWriter`,
    or None when the native library cannot be built (the sync fallback
    inside save_checkpoint then applies).  Used by the solvers'
    ``saveEachIteration`` paths so per-iteration checkpoints ride the
    native worker thread instead of blocking the solve loop."""
    global _DEFAULT_WRITER, _DEFAULT_WRITER_TRIED
    if not _DEFAULT_WRITER_TRIED:
        _DEFAULT_WRITER_TRIED = True
        try:
            from ..io.fastwriter import AsyncWriter
            w = AsyncWriter()
            _DEFAULT_WRITER = w if w.available else None
        except Exception:
            _DEFAULT_WRITER = None
    return _DEFAULT_WRITER


def save_checkpoint(saveDir: str, tag, vectors: List, status: dict,
                    eigencoefficients=None, eigenvalues=None,
                    async_writer=None):
    """Save a Krylov basis plus solver metadata under ``saveDir``.

    Layout: ``{saveDir}/vec_{tag}_{i}.npz`` per vector plus
    ``{saveDir}/meta_{tag}.npz``.

    :param async_writer: an object with ``submit_npz(path, **arrays)`` —
        snapshots are serialized in memory and handed to its worker thread,
        so the solver loop doesn't block on disk.  Call
        ``async_writer.flush()`` before relying on the files.
    """
    os.makedirs(saveDir, exist_ok=True)
    meta = {
        "n_vectors": np.asarray(len(vectors)),
        "status_json": np.asarray(json.dumps(_jsonable(status))),
    }
    if eigencoefficients is not None:
        meta["eigencoefficients"] = np.asarray(eigencoefficients)
    if eigenvalues is not None:
        meta["eigenvalues"] = np.asarray(eigenvalues)

    if async_writer is not None:
        for i, v in enumerate(vectors):
            async_writer.submit_npz(
                os.path.join(saveDir, f"vec_{tag}_{i}.npz"),
                **v.to_state_dict())
        async_writer.submit_npz(os.path.join(saveDir, f"meta_{tag}.npz"),
                                **meta)
        return
    for i, v in enumerate(vectors):
        np.savez(os.path.join(saveDir, f"vec_{tag}_{i}.npz"),
                 **v.to_state_dict())
    np.savez(os.path.join(saveDir, f"meta_{tag}.npz"), **meta)


def load_checkpoint(saveDir: str, tag, typeClass, options: Optional[dict] = None,
                    device=None):
    """Load a saved basis back as a list of ``typeClass`` vectors, placed
    on ``device`` (default: the card, as ``TorchVector`` places arrays).

    :returns: (vectors, meta dict with status/eigencoefficients/eigenvalues)
    """
    meta_raw = np.load(os.path.join(saveDir, f"meta_{tag}.npz"),
                       allow_pickle=False)
    n = int(meta_raw["n_vectors"])
    vectors = []
    for i in range(n):
        state = dict(np.load(os.path.join(saveDir, f"vec_{tag}_{i}.npz"),
                             allow_pickle=False))
        vectors.append(typeClass.from_state_dict(state, options=options,
                                                  device=device))
    meta = {"status": json.loads(str(meta_raw["status_json"]))}
    for key in ("eigencoefficients", "eigenvalues"):
        if key in meta_raw:
            meta[key] = meta_raw[key]
    return vectors, meta


def latest_tag(saveDir: str):
    """Return the highest numeric checkpoint tag in ``saveDir`` or None."""
    if not os.path.isdir(saveDir):
        return None
    tags = []
    for name in os.listdir(saveDir):
        if name.startswith("meta_") and name.endswith(".npz"):
            t = name[len("meta_"):-len(".npz")]
            try:
                tags.append(int(t))
            except ValueError:
                continue
    return max(tags) if tags else None


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.generic,)):
        return obj.item()
    if isinstance(obj, (bool, int, float, str)) or obj is None:
        return obj
    return repr(obj)
