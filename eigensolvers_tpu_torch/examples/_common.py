"""What the example drivers share: the device (the card unless ``--cpu``),
the output directory (``--out``, default ``build/artifacts/``), the
committed CH3CN records and rung states under ``artifacts/`` (read only:
nothing here writes there), and the rung-state files."""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ART = os.path.join(ROOT, "artifacts")
OUT = os.path.join(ROOT, "build", "artifacts")
LOG_NAME = "ch3cn_production.jsonl"
REF_ZPVE_CM1 = 9837.4069          # reference: examples/ttns2_ch3cn.py:28
TARGET_CM = 360.0                 # reference: examples/ttns2_ch3cn.py:27


def parser(doc: str, out: bool = False) -> argparse.ArgumentParser:
    """An argument parser with ``--cpu`` (and ``--out DIR`` for drivers
    that write files)."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    if out:
        ap.add_argument("--out", default=OUT,
                        help=f"output directory (default {OUT})")
    return ap


def resolve_device(device=None) -> torch.device:
    """``device`` if given, else the card; without one this raises and
    names ``--cpu`` instead of carrying on on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the examples run on the card; "
                           "pass --cpu (device=\"cpu\") to run on the CPU")
    return torch.device("cuda")


def device_arg(args) -> torch.device:
    return resolve_device("cpu" if args.cpu else None)


def out_dir(out=None) -> str:
    """The output directory, made if missing; never ``artifacts/``."""
    out = os.path.abspath(OUT if out is None else out)
    if os.path.realpath(out) == os.path.realpath(ART):
        raise ValueError("the examples never write into artifacts/; "
                         "pass another --out")
    os.makedirs(out, exist_ok=True)
    return out


def out_file(out, name: str) -> str:
    return os.path.join(out_dir(out), name)


def read_records(path: str) -> list:
    recs = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    recs.append(json.loads(line))
                except ValueError:
                    continue
    return recs


def committed_records() -> list:
    """The JAX package's committed CH3CN records (read only)."""
    return read_records(os.path.join(ART, LOG_NAME))


def append_record(out, rec: dict) -> None:
    with open(out_file(out, LOG_NAME), "a") as f:
        f.write(json.dumps(rec) + "\n")


def tree_zpve_cm1(N: int, recs) -> float | None:
    """A rung's zpve from the tree ZPVE ladder's records (the first
    matching line, as the JAX drivers' ``_zpve_cm1``)."""
    for d in recs:
        if d.get("topology") == "tree" and d.get("kind") is None \
                and int(d.get("N", -1)) == N:
            return float(d["zpve_cm1"])
    return None


def rung_zpve_cm1(N: int, out) -> float | None:
    """The committed records first, then the output directory's own."""
    return tree_zpve_cm1(N, committed_records() + read_records(
        os.path.join(os.path.abspath(OUT if out is None else out),
                     LOG_NAME)))


def load_tensors(path: str) -> list:
    """A rung state ``t0, t1, ...`` as numpy arrays."""
    with np.load(path) as z:
        return [z[f"t{j}"] for j in range(len(z.files))]


def to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().resolve_conj().cpu().numpy()
    return np.asarray(t)


def save_tensors(path: str, tensors) -> None:
    np.savez(path, **{f"t{j}": to_numpy(t) for j, t in enumerate(tensors)})


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def peak_memory(device) -> str:
    """``; peak device memory X GB`` on the card, else nothing."""
    if torch.device(device).type != "cuda":
        return ""
    gb = torch.cuda.max_memory_allocated() / 1e9
    return f"; peak device memory {gb:.3f} GB"


class Wall:
    """Host-clock wall of a block, synchronized with the card at both ends."""

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        sync(self.device)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        sync(self.device)
        self.s = time.perf_counter() - self.t0
