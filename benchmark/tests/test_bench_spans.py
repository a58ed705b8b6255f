"""The program's spans as the benchmark reads them: the port's own apply
counts against the benchmark's wrapper on the CPU cell, the reduction of
a trace's ``es.*`` ranges (``harness/spans.py``), and the accepted
metrics unmoved by the program's ranges in the trace."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import program_spans
from benchmark.harness import core, spans, spec
from benchmark.harness.tracing import ApplyCounter, profiler, reduce_profile

from .conftest import small_sizes

SEED = 3_141_592_653_589


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(events))))


@pytest.fixture(scope="module")
def cell_solves():
    """Solve 1 of the CPU cell twice, with the wrapper on the operator:
    profiled, then not; each with the port's counters' gain over it."""
    from eigensolvers_tpu_torch.utils.profiling import delta, snapshot
    cell = core.Cell("ch3cn6.lanczos3", device=torch.device("cpu"),
                     sizes=small_sizes("ch3cn6"))
    cell.warm_up(SEED)
    cell.counter = ApplyCounter(cell.op)
    out = []
    for prof in (profiler(cell.device), None):
        before = snapshot()
        rec = cell.solve(SEED, 1, prof)
        out.append((rec, delta(before), prof))
    cell.free_operator()
    return out


@pytest.mark.parametrize("profiled", [True, False])
def test_program_applies_equal_the_wrapper(cell_solves, profiled):
    rec, counts, _ = cell_solves[0 if profiled else 1]
    assert counts["es.apply"]["calls"] == rec["applies"] > 0
    if profiled:
        assert program_spans.program_shapes(counts) == \
            program_spans.wrapper_shapes(rec["shapes"])
    # the same with and without a profiler
    other = cell_solves[1 - profiled][1]
    assert ({k: v["calls"] for k, v in counts.items()}
            == {k: v["calls"] for k, v in other.items()})


def test_cell_counters_read(cell_solves):
    """The counts that ``host_reads_per_solve`` reads, and the set-up's
    build that ``build_s`` reads, are there on the CPU cell."""
    counts = cell_solves[1][1]
    assert counts["es.read"]["calls"] > counts["es.minres.pass"]["calls"] > 0
    assert spec.metric_reader("build_s")({"solves": [], "profile": None}) > 0


def _accepted(red, solves):
    """The accepted per-layer metrics' values from a reduction."""
    record = {"solves": solves, "profile": dict(red, wall_s=1.0, applies=2,
                                                op_bound_s=1e-8)}
    return {m["name"]: spec.metric_reader(m["name"])(record)
            for m in spec.benchmark()["per_layer"] if m["name"] != "build_s"}


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
    # the accepted reduction of the same trace, its op.apply ranges
    assert reduce_profile(_prof(TRACE))["op_device_s"] * 1e9 == \
        pytest.approx(160)


@pytest.mark.parametrize("source", ["cell", "synthetic"])
def test_accepted_metrics_unmoved_by_program_ranges(cell_solves, source):
    """One trace reduced with and without the ``es.*`` ranges (the CPU
    cell's profiled solve, and the trace above with its device time):
    every accepted metric reads the same."""
    rec, _, prof = cell_solves[0]
    events = (prof.profiler.kineto_results.events() if source == "cell"
              else TRACE)
    plain = [e for e in events if not e.name().startswith("es.")]
    assert len(plain) < len(events)
    solves = [rec, dict(cell_solves[1][0], profiled=False)]
    with_es = _accepted(reduce_profile(_prof(events)), solves)
    assert with_es == _accepted(reduce_profile(_prof(plain)), solves)
    if source == "synthetic":
        assert None not in with_es.values()


def test_program_spans_run(cpu, capsys):
    """``program_spans.py`` runs a traced cell and prints its readings;
    the harness it observes is left as it was."""
    solve0 = core.Cell.solve
    assert program_spans.main(
        ["--workload", "ch3cn6.lanczos3", "--seed", str(SEED), "--seconds",
         "0", "--trace", "1"], device=cpu, sizes=small_sizes("ch3cn6")) == 0
    err = capsys.readouterr().err
    assert core.Cell.solve is solve0
    assert "[spans] host_reads_per_solve" in err and "es.build" in err
    assert "[spans] solve 1: applies" in err
