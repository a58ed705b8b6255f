"""The port stands alone: importing it loads no jax (the JAX package's
import turns on x64 for the whole process), and every module imports
without nvcc, CUDA or triton, because the kernels are built on first use."""

import json
import pathlib
import re
import subprocess
import sys

PKG = pathlib.Path(__file__).resolve().parents[1] / "eigensolvers_tpu_torch"

_PROBE = """
import importlib, json, pkgutil, sys
import eigensolvers_tpu_torch as pkg
after_init = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from eigensolvers_tpu_torch.ops import kernels
print(json.dumps({
    "jax_after_init": after_init,
    "jax_after_all": sorted(m for m in sys.modules
                            if m == "jax" or m.startswith("jax.")),
    "jax_package": sorted(m for m in sys.modules
                          if m.split(".")[0] == "eigensolvers_tpu"),
    "modules": names,
    "built": kernels.bsr_spmv_library.cache_info().currsize
             + kernels.bsr_spmm_library.cache_info().currsize,
    "triton": "triton" in sys.modules,
}))
"""


def test_importing_every_module_loads_no_jax_and_builds_nothing():
    proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                          text=True, cwd=PKG.parent, timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["jax_after_init"] == [] and got["jax_after_all"] == []
    assert got["jax_package"] == []
    assert {"eigensolvers_tpu_torch.ops.sparse",
            "eigensolvers_tpu_torch.ops.linear_solvers",
            "eigensolvers_tpu_torch.solvers.step",
            "eigensolvers_tpu_torch.solvers.fast_lanczos"} <= set(got["modules"])
    assert got["built"] == 0 and not got["triton"]


def test_sources_never_import_jax_or_the_jax_package():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax\b|jaxlib\b|eigensolvers_tpu\b(?!_torch))",
        re.M)
    offenders = [str(p) for p in PKG.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert offenders == []
