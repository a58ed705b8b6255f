"""The program's spans as the benchmark reads them: the port's own counts
in the record of a traced run of the CPU cell (``core.run``), against
the benchmark's wrapper and with and without a profiler; the per-layer
metrics that read them; the reduction of a trace's ``es.*`` ranges
(``harness/spans.py``); and the accepted metrics unmoved by the
program's ranges in the trace."""

import contextlib
import io
import math
import warnings
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import core, spans, spec, tracing
from benchmark.harness.tracing import reduce_profile, wrapper_shapes

from .conftest import config_of, small_sizes

SEED = 3_141_592_653_589
CELL = spec.benchmark()["workloads"][0]["name"]
# the per-layer metrics that read the benchmark's wrapper and its op.apply
# ranges, not the port's spans
ACCEPTED = ("applies_per_solve", "ms_per_apply", "op_ms_per_apply",
            "op_roofline", "device_idle")


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(events))))


def _read(name, record):
    return spec.metric_reader(name)(record)


@pytest.fixture(scope="module")
def traced_runs():
    """The CPU cell's traced run as ``core.run`` makes it, twice: profiling
    solve 1, as every run does, and profiling solve 0, so that one solve
    is counted with a profiler and without.  Each: (the run's record, the
    profiler of its profiled solve, what it printed on standard
    error)."""
    made, out = [], {}

    def keep(device):
        made.append(tracing.profiler(device))
        return made[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(core, "profiler", keep)
        for profiled in (1, 0):
            mp.setattr(core, "PROFILED", profiled)
            err = io.StringIO()
            with contextlib.redirect_stderr(err), \
                    warnings.catch_warnings():
                warnings.simplefilter("ignore")
                _, record = core.run(CELL, SEED, 0.0, True, 0.0,
                                     device=torch.device("cpu"),
                                     sizes=small_sizes(config_of(CELL)))
            out[profiled] = (record, made[-1], err.getvalue())
    return out


@pytest.mark.parametrize("profiled", [True, False])
def test_program_applies_equal_the_wrapper(traced_runs, profiled):
    """Solve 0, profiled in one run and not in the other: the port's apply
    count is the wrapper's, by shape where the wrapper records shapes,
    and every count is the same with and without a profiler."""
    rec, other = (traced_runs[0 if profiled else 1][0]["solves"][0],
                  traced_runs[1 if profiled else 0][0]["solves"][0])
    assert rec["profiled"] is profiled and other["profiled"] is not profiled
    counts = rec["counts"]
    assert counts["es.apply"]["calls"] == rec["applies"] > 0
    if profiled:
        assert spans.program_shapes(counts) == wrapper_shapes(rec["shapes"])
    assert ({k: v["calls"] for k, v in counts.items()}
            == {k: v["calls"] for k, v in other["counts"].items()})


def test_cell_counters_read(traced_runs):
    """The counts that ``host_reads_per_solve`` reads, and the set-up's
    build that ``build_s`` reads, are in the record of the CPU cell."""
    record = traced_runs[1][0]
    counts = record["solves"][0]["counts"]
    assert counts["es.read"]["calls"] > counts["es.minres.pass"]["calls"] > 0
    assert _read("build_s", record) > 0
    # the process's counters: one build a run, more in a test process
    assert record["setup_counts"]["es.build"]["calls"] >= 1


def test_new_readings_on_the_record(traced_runs):
    """The three readings of the port's spans from the CPU cell's record:
    the host reads of its unprofiled solve, and nothing, not 0, from a
    trace that holds no device time."""
    record = traced_runs[1][0]
    reads = _read("host_reads_per_solve", record)
    assert math.isfinite(reads)
    assert reads == record["solves"][0]["counts"]["es.read"]["calls"]
    assert record["spans"]["spans"]["es.minres.pass"]["calls"] > 0
    assert record["spans"]["device_s"] == 0
    assert _read("loop_ms_per_pass", record) is None
    assert _read("driver_share", record) is None
    # with no unprofiled solve (the run that profiles solve 0): nothing
    assert _read("host_reads_per_solve", traced_runs[0][0]) is None


def _accepted(red, solves):
    """The accepted per-layer metrics' values from a reduction."""
    record = {"solves": solves, "profile": dict(red, wall_s=1.0, applies=2,
                                                op_bound_s=1e-8)}
    return {name: _read(name, record) for name in ACCEPTED}


class E:
    """A kineto event: on the host (``dev`` 0) or the card (1)."""

    def __init__(self, dev, name, start, dur, corr=0, link=0):
        from torch.autograd import DeviceType
        self._d = DeviceType.CUDA if dev else DeviceType.CPU
        self._v = (name, start, dur, corr, link)

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
        return False


# one outer iteration: a linear solve of one MINRES pass (an apply with a
# kernel and a ctypes kernel whose launch the trace lacks, the pass's
# vector work, a read), then the driver's own kernel
TRACE = [
    E(0, "es.lanczos.outer", 0, 1000), E(0, "es.linear.solve", 10, 700),
    E(0, "es.minres.pass", 20, 600),
    E(0, "es.apply", 30, 200), E(0, "op.apply", 30, 200),
    E(0, "cudaLaunchKernel", 40, 5, 11, 1),
    E(0, "cudaLaunchKernel", 300, 5, 12, 1),
    E(0, "es.read", 400, 150), E(0, "cudaMemcpyAsync", 410, 5, 13, 1),
    E(0, "cudaLaunchKernel", 800, 5, 14, 1),
    E(1, "gemm", 100, 100, 11), E(1, "ctypes_k", 200, 60, 99),
    E(1, "axpy", 310, 40, 12), E(1, "memcpy", 420, 10, 13),
    E(1, "gs", 850, 50, 14),
]


def test_reduce_spans_places_and_attributes():
    red = spans.reduce_spans(_prof(TRACE))
    sp = red["spans"]
    assert sp["es.apply"]["device_s"] * 1e9 == pytest.approx(160)
    assert sp["es.minres.pass"]["device_s"] * 1e9 == pytest.approx(40)
    assert sp["es.read"]["device_s"] * 1e9 == pytest.approx(10)
    assert sp["es.lanczos.outer"]["device_s"] * 1e9 == pytest.approx(50)
    assert sp["es.minres.pass"]["calls"] == 1
    assert sp["es.apply"]["host_s"] * 1e9 == pytest.approx(200)
    assert red["by_stream_order"] == 1
    assert red["device_s"] * 1e9 == pytest.approx(260)
    # idle: 260-310 and 350-420 under the pass (midpoints 285, 385),
    # 430-850 under the linear solve, the pass ended (midpoint 640)
    assert sp["es.minres.pass"]["idle_s"] * 1e9 == pytest.approx(50 + 70)
    assert sp["es.linear.solve"]["idle_s"] * 1e9 == pytest.approx(420)
    assert sp["es.read"]["idle_s"] == 0
    assert red["idle_s"] * 1e9 == pytest.approx(540)
    assert "device" in spans.line(red) and "idle" in spans.line(red)


def test_reduce_spans_gives_the_new_readings():
    """What loop_ms_per_pass and driver_share read: the pass's device time
    outside its apply over its calls, the device time outside every
    linear solve over all of it."""
    red = spans.reduce_spans(_prof(TRACE))
    loop = spans.device_s(red, "es.minres.pass", ["es.apply"])
    assert loop * 1e9 == pytest.approx(50)
    driver = spans.device_s(red, outside=["es.linear.solve"])
    assert 100 * driver / red["device_s"] == pytest.approx(100 * 50 / 260)
    record = {"solves": [], "spans": red}
    assert _read("loop_ms_per_pass", record) == pytest.approx(50e-9 * 1e3)
    assert _read("driver_share", record) == pytest.approx(100 * 50 / 260)
    # the accepted reduction of the same trace, its op.apply ranges
    assert reduce_profile(_prof(TRACE))["op_device_s"] * 1e9 == \
        pytest.approx(160)


@pytest.mark.parametrize("source", ["cell", "synthetic"])
def test_accepted_metrics_unmoved_by_program_ranges(traced_runs, source):
    """One trace reduced with and without the ``es.*`` ranges (the CPU
    cell's profiled solve, and the trace above with its device time):
    every accepted metric reads the same."""
    record, prof, _ = traced_runs[1]
    events = (prof.profiler.kineto_results.events() if source == "cell"
              else TRACE)
    plain = [e for e in events if not e.name().startswith("es.")]
    assert len(plain) < len(events)
    solves = record["solves"]
    with_es = _accepted(reduce_profile(_prof(events)), solves)
    assert with_es == _accepted(reduce_profile(_prof(plain)), solves)
    if source == "synthetic":
        assert None not in with_es.values()


def test_traced_run_prints_spans(traced_runs):
    """A traced run prints the port's counts of every solve beside the
    wrapper's, the set-up's parse and build, its spans, and its per-layer
    metrics."""
    record, _, err = traced_runs[1]
    reads = record["solves"][0]["counts"]["es.read"]["calls"]
    assert f"host reads {reads}, linear solves" in err
    assert "[spans] solve 1: applies" in err and "(profiled)" in err
    assert "[spans] set-up" in err and "es.build" in err
    # the paths come with device time: none on the CPU
    assert "[spans] device" in err and "[spans] path" not in err
    assert "[per_layer] applies_per_solve" in err
    assert "host_reads_per_solve" in err
