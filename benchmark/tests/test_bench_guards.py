"""What a run checks about its process, and the shape of what it prints."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import run
from benchmark.harness import core, guards, spec
from benchmark.harness.tracing import reduce_profile

from .conftest import ROOT, config_of, small_sizes

CELL = spec.benchmark()["workloads"][0]["name"]


def test_forbidden_modules_compared_whole():
    assert guards.forbidden_modules(["jax", "numpy"]) == ["jax"]
    assert guards.forbidden_modules(["jaxlib.xla_client"]) == ["jaxlib"]
    assert guards.forbidden_modules(["eigensolvers_tpu.ops.sparse"]) == [
        "eigensolvers_tpu"]
    assert guards.forbidden_modules(
        ["eigensolvers_tpu_torch", "eigensolvers_tpu_torch.ops", "jaxtyping",
         "flaxen"]) == []


def test_run_refuses_a_planted_jax(monkeypatch, capsys):
    """With a module of JAX loaded, the run exits 4 and prints no
    result."""
    monkeypatch.setattr(core, "run", lambda *a, **k: ({"checks": {}}, {}))
    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    rc = run.main(["--workload", CELL, "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc == 4 and out.out == "" and "jax" in out.err


def test_no_card_no_result():
    """Without CUDA the run exits non-zero with nothing on stdout."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        CELL, "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 3 and p.stdout == ""


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(trace, cpu, capsys):
    """The result's keys, its metrics as BENCHMARK.json names them for the
    run's kind, the checks last on both streams."""
    result, _ = core.run(CELL, 3_999_999_999_7, 0.0, bool(trace), 0.0,
                         device=cpu, sizes=small_sizes(config_of(CELL)))
    core.emit(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert isinstance(line["correct"], bool)
    assert 0 <= line["failed"] <= line["attempted"]
    assert line["attempted"] >= 1 + trace
    kind = "per_layer" if trace else "end_to_end"
    metrics = spec.metrics_of(spec.benchmark(), CELL, kind)
    # on the CPU: no peak, no device time; the rest is there
    assert set(line["metrics"]) == {
        m["name"] for m in metrics if m["source"] != "device_trace"} - {
        "peak_mem_gib"}
    assert err.strip().splitlines()[-1].startswith("correct ")
    assert err.strip().splitlines()[-2].startswith("check unconverged")


class _Event:
    def __init__(self, dev, name, start, dur, corr, link, annot=False):
        from torch.autograd import DeviceType
        self._d = DeviceType.CUDA if dev else DeviceType.CPU
        self._v = (name, start, dur, corr, link, annot)

    def device_type(self):
        return self._d

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def linked_correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def test_reduce_profile_attributes_by_call_and_stream_order():
    """Kernels inside op.apply found by their runtime call or, without
    one, by their place on the stream between known launches; kernels
    outside left out; busy time the union."""
    E = _Event
    events = [
        E(0, "aten::add", 0, 10, 1, 0), E(0, "cudaLaunchKernel", 2, 1, 101, 1),
        E(0, "op.apply", 20, 30, 2, 0),
        E(0, "aten::mul", 22, 5, 3, 0), E(0, "cudaLaunchKernel", 23, 1, 102, 3),
        E(0, "aten::sub", 30, 5, 4, 0),            # no runtime call held
        E(0, "aten::add", 60, 10, 5, 0), E(0, "cudaLaunchKernel", 61, 1, 103, 5),
        E(1, "add_k", 100, 10, 101, 1), E(1, "mul_k", 110, 20, 102, 3),
        E(1, "sub_k", 130, 5, 999, 4), E(1, "ctypes_k", 135, 40, 555, 0),
        E(1, "add_k", 200, 10, 103, 5), E(1, "op.apply", 100, 100, 7, 2, True),
    ]
    prof = type("P", (), {})()
    prof.profiler = type("Q", (), {})()
    prof.profiler.kineto_results = type("R", (), {"events": lambda self: events})()
    red = reduce_profile(prof)
    assert red["op_device_s"] * 1e9 == pytest.approx(20 + 5 + 40)
    assert red["busy_s"] * 1e9 == pytest.approx(75 + 10)
    assert red["events"]["by_launch_call"] == 3
    assert red["events"]["by_stream_order"] == 2
