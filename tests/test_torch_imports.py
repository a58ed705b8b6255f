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
    "built": sum(lib.cache_info().currsize for lib in kernels.LIBRARIES),
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
            "eigensolvers_tpu_torch.solvers.fast_lanczos",
            "eigensolvers_tpu_torch.solvers.feast",
            "eigensolvers_tpu_torch.solvers.fast_feast",
            "eigensolvers_tpu_torch.solvers.chebyshev",
            "eigensolvers_tpu_torch.solvers.slicing",
            "eigensolvers_tpu_torch.utils.quadrature",
            "eigensolvers_tpu_torch.models.op_parser",
            "eigensolvers_tpu_torch.models.molecules",
            "eigensolvers_tpu_torch.vectors.mps",
            "eigensolvers_tpu_torch.vectors.mps_sweeps",
            "eigensolvers_tpu_torch.vectors.ttns",
            "eigensolvers_tpu_torch.vectors.ttns_sweeps",
            "eigensolvers_tpu_torch.vectors.numpy_backend",
            "eigensolvers_tpu_torch.io",
            "eigensolvers_tpu_torch.io.fastwriter",
            "eigensolvers_tpu_torch.parallel",
            "eigensolvers_tpu_torch.parallel.mesh",
            "eigensolvers_tpu_torch.parallel.sharded",
            "eigensolvers_tpu_torch.parallel.spmd",
            "eigensolvers_tpu_torch.parallel.launch",
            "eigensolvers_tpu_torch.graft_entry"} <= set(got["modules"])
    assert {f"eigensolvers_tpu_torch.examples.{name}"
            for name in PORTED_EXAMPLES + ("_common",)} <= set(got["modules"])
    assert {f"eigensolvers_tpu_torch.tools.{name}"
            for name in PORTED_TOOLS} <= set(got["modules"])
    assert got["built"] == 0 and not got["triton"]


# the JAX package's examples/ with a counterpart in the port; none is
# queued any more (ROADMAP A.15 is done)
PORTED_EXAMPLES = (
    "driver_dense", "ch3cn_excited_production", "ch3cn_tree_production",
    "feast_window", "chebyshev_window", "spectrum_slicing",
    "state_following_ho", "pyrazine_vibronic", "mps_sop_lanczos",
    "ttns_tree_lanczos", "ch3cn_feast_production", "ch3cn_dmrg_zpve",
    "ch3cn_targeted_lanczos", "ch3cn_block_lanczos", "ch3cn_feast",
    "ch3cn_production", "ch3cn_maxd_ladder", "ch3cn_representation_check",
    "ch3cn_representation_2mode")
QUEUED_EXAMPLES = ()
# the JAX package's tools/: ported under eigensolvers_tpu_torch/tools/, or
# left out with the reason
PORTED_TOOLS = ("diag_feast_filter",)
LEFT_OUT_TOOLS = {
    "feast_partial_record": "appends hard-coded, empty rows (ROADMAP C.3)",
    "gen_readme_perf": "reads the earlier benchmark's results; waits for "
                       "the port's own benchmark"}


def test_every_example_is_ported_or_queued():
    """Each ``examples/X.py`` of the JAX package is either
    ``eigensolvers_tpu_torch/examples/X.py`` (with ``run`` and ``main``,
    which the import probe above loads without jax) or queued; so is
    ``run_clean``."""
    jax_side = sorted(p.stem for p in (PKG.parent / "examples").glob("*.py"))
    assert sorted(PORTED_EXAMPLES + QUEUED_EXAMPLES) == jax_side
    for name in PORTED_EXAMPLES:
        text = (PKG / "examples" / f"{name}.py").read_text()
        assert "\ndef run(" in text and "\ndef main(" in text, name
    assert (PKG / "examples" / "run_clean").stat().st_mode & 0o111


def test_every_tool_is_ported_or_left_out():
    """Each ``tools/X.py`` of the JAX package is
    ``eigensolvers_tpu_torch/tools/X.py`` (with ``run`` and ``main``) or
    named in ``LEFT_OUT_TOOLS`` with its reason, and no left-out tool has a
    counterpart."""
    jax_side = sorted(p.stem for p in (PKG.parent / "tools").glob("*.py"))
    assert sorted(PORTED_TOOLS + tuple(LEFT_OUT_TOOLS)) == jax_side
    for name in PORTED_TOOLS:
        text = (PKG / "tools" / f"{name}.py").read_text()
        assert "\ndef run(" in text and "\ndef main(" in text, name
    for name, why in LEFT_OUT_TOOLS.items():
        assert why and not (PKG / "tools" / f"{name}.py").exists(), name


def test_sources_never_import_jax_or_the_jax_package():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax\b|jaxlib\b|eigensolvers_tpu\b(?!_torch))",
        re.M)
    offenders = [str(p) for p in PKG.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert offenders == []


def test_op_files_ship_inside_the_package():
    """The molecule models read the package's own .op files, which live in
    the package directory (no path outside it, nothing downloaded)."""
    from eigensolvers_tpu_torch.models import molecules
    data = PKG / "models" / "data"
    assert sorted(p.name for p in data.glob("*.op")) == ["ch3cn.op",
                                                         "pyr4+.op"]
    for path in (molecules.PYR4_OP, molecules.CH3CN_OP):
        assert pathlib.Path(path).resolve().parent == data
        assert pathlib.Path(path).stat().st_size > 0


# F6: the names the JAX package exports, where it exports them.  Not yet
# ported (ROADMAP Queue A): the sharded backend and the distributed layer
# (A.11).
NOT_PORTED_NAMES = {"ShardedVector"}
NOT_PORTED_MODULES = {"parallel"}
RENAMED = {"JaxVector": "TorchVector"}


def _jax_exports():
    """(module path below the package, names) of every ``__all__`` in the
    JAX package, read from its sources (no jax import)."""
    import ast
    root = PKG.parent / "eigensolvers_tpu"
    for path in sorted(root.rglob("*.py")):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.Assign) and any(
                    getattr(t, "id", None) == "__all__" for t in node.targets):
                parts = path.relative_to(root).with_suffix("").parts
                if parts[-1] == "__init__":
                    parts = parts[:-1]
                yield ".".join(parts), ast.literal_eval(node.value)


def test_jax_exports_import_from_the_same_module_in_the_port():
    import importlib
    seen = set()
    for sub, names in _jax_exports():
        if sub.split(".")[0] in NOT_PORTED_MODULES:
            continue
        mod = importlib.import_module(
            "eigensolvers_tpu_torch" + ("." + sub if sub else ""))
        listed = getattr(mod, "__all__", None)
        for name in names:
            if name in NOT_PORTED_NAMES:
                continue
            mine = RENAMED.get(name, name)
            assert hasattr(mod, mine), f"{mod.__name__} lacks {mine}"
            assert listed is None or mine in listed, \
                f"{mine} not in {mod.__name__}.__all__"
            seen.add((sub, name))
    assert ("", "chebyshevFilteredDiagonalization") in seen
    assert ("solvers", "spectrumSlicingDiagonalization") in seen
    assert ("ops", "BandedOperator") in seen and ("", "FeastConfig") in seen
    assert ("", "TTNSVector") in seen and ("io", "AsyncWriter") in seen
    assert ("", "tree_dmrg_eigensolve") in seen and ("", "NumpyVector") in seen


def test_trace_takes_the_jax_arguments():
    from eigensolvers_tpu_torch.utils.profiling import trace
    with trace(None, host_tracer_level=1) as prof:
        assert prof is None


def test_chip_smoke_and_the_distributed_layer_import_no_jax():
    """chip_smoke.py and the distributed layer's sources name neither jax
    nor the JAX package, and importing the layer starts no process group
    (a mesh is built on demand, not at import)."""
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax\b|jaxlib\b|eigensolvers_tpu\b(?!_torch))",
        re.M)
    root = PKG.parent
    for path in [root / "chip_smoke.py", *(PKG / "parallel").glob("*.py"),
                 PKG / "graft_entry.py"]:
        assert not pattern.search(path.read_text()), path
    probe = ("import torch.distributed as d, eigensolvers_tpu_torch.parallel,"
             " eigensolvers_tpu_torch.graft_entry; print(d.is_initialized())")
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                          text=True, cwd=root, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "False"
