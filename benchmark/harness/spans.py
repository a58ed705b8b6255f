"""The program's own spans in one profiled solve.  The port puts every
region it names (``eigensolvers_tpu_torch/utils/profiling.py``: driver
iterations and phases, linear solves, MINRES passes, operator applies,
host reads) in a ``record_function`` range whose name starts with
``es.`` while a profiler records.  From such a trace, for each name: its
calls and host seconds, and the device seconds of the operations launched
inside it and not inside a nested ``es.*`` range; the device's idle time
by the innermost ``es.*`` range that was open on the host at each gap's
midpoint; and the device seconds by the whole path of ranges open at each
operation's launch (``paths``), from which :func:`device_s` takes any
region (inside one span, outside others).

A device operation is launched where the host made the runtime call that
shares its correlation id.  One whose call the trace does not hold (a
kernel launched through a library's own static CUDA runtime, as the
port's ctypes kernels are) ran, on its one stream, after the known
launches before it and before those after it: it is placed at the
midpoint of that interval, or at its start when none follows."""

import collections

from .tracing import _merge

PREFIX = "es."
NONE = "(none)"


def _paths_at(ranges, times):
    """For each of ``times`` (any order) the names of the ``ranges``
    ((start, end, name), properly nested, sorted by start and outer
    first) open at it, outermost first."""
    out = [()] * len(times)
    stack, i = [], 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while i < len(ranges) and ranges[i][0] <= t:
            s, e, name = ranges[i]
            while stack and stack[-1][0] < s:
                stack.pop()
            stack.append((e, name))
            i += 1
        while stack and stack[-1][0] < t:
            stack.pop()
        out[q] = tuple(n for _, n in stack)
    return out


def reduce_spans(prof):
    """The ``es.*`` ranges of one ``torch.profiler`` trace (see the module
    docstring): ``{"spans": {name: {calls, host_s, device_s, idle_s}},
    "paths": [[names, device_s], ...], "device_s", "busy_s", "idle_s",
    "by_stream_order"}``, seconds throughout; idle that no range covered
    is under ``"(none)"``."""
    from torch.autograd import DeviceType
    ranges = []                     # (start, end, name) of es.* ranges
    calls = {}                      # runtime call's id -> its start
    dev = []                        # (start, end, correlation id)
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        if e.device_type() == DeviceType.CPU:
            if e.linked_correlation_id():
                calls[e.correlation_id()] = s
            if e.name().startswith(PREFIX):
                ranges.append((s, s + e.duration_ns(), e.name()))
        elif e.device_type() == DeviceType.CUDA \
                and not e.is_user_annotation():
            dev.append((s, s + e.duration_ns(), e.correlation_id()))
    ranges.sort(key=lambda r: (r[0], -r[1]))
    dev.sort()
    launch = [calls.get(c) for _, _, c in dev]
    known = [t for t in launch if t is not None]
    by_order, j, prev = 0, 0, None
    for k, t in enumerate(launch):
        if t is not None:
            prev, j = t, j + 1
            continue
        by_order += 1
        nxt = known[j] if j < len(known) else None
        launch[k] = (prev if nxt is None else
                     nxt if prev is None else 0.5 * (prev + nxt))
    placed = [k for k, t in enumerate(launch) if t is not None]
    paths = collections.Counter()
    for k, path in zip(placed, _paths_at(ranges, [launch[k]
                                                  for k in placed])):
        paths[path] += dev[k][1] - dev[k][0]
    merged, busy_ns = _merge([(s, e) for s, e, _ in dev])
    gaps = [(e0, s1) for (_, e0), (s1, _) in zip(merged, merged[1:])]
    idle = collections.Counter()
    for (e0, s1), path in zip(gaps, _paths_at(
            ranges, [0.5 * (e0 + s1) for e0, s1 in gaps])):
        idle[path[-1] if path else NONE] += s1 - e0
    spans = {}
    for s, e, name in ranges:
        d = spans.setdefault(name, {"calls": 0, "host_s": 0.0,
                                    "device_s": 0.0, "idle_s": 0.0})
        d["calls"] += 1
        d["host_s"] += (e - s) / 1e9
    for path, ns in paths.items():
        if path:
            spans[path[-1]]["device_s"] += ns / 1e9
    for name, ns in idle.items():
        spans.setdefault(name, {"calls": 0, "host_s": 0.0, "device_s": 0.0,
                                "idle_s": 0.0})["idle_s"] += ns / 1e9
    return {"spans": spans,
            "paths": [[list(p), ns / 1e9] for p, ns in paths.most_common()],
            "device_s": sum(e - s for s, e, _ in dev) / 1e9,
            "busy_s": busy_ns / 1e9,
            "idle_s": sum(idle.values()) / 1e9,
            "by_stream_order": by_order}


def program_shapes(counts):
    """The port's ``es.apply.m<lanes>.<dtype>`` counters as
    {"<lanes>x<dtype>": applies}."""
    out = collections.Counter()
    for name, c in counts.items():
        p = name.split(".")
        if len(p) == 4 and p[:2] == ["es", "apply"] and p[2][:1] == "m":
            out[f"{p[2][1:]}x{p[3]}"] += c["calls"]
    return dict(out)


def device_s(red, inside=None, outside=()):
    """Device seconds of the operations launched inside a range named
    ``inside`` (any, where None) and inside no range named in
    ``outside``."""
    out = set(outside)
    return sum(s for p, s in red["paths"]
               if (inside is None or inside in p) and not out & set(p))


def line(red, top=6):
    """One line: the spans with most device time of their own, and the
    idle by span."""
    sp = red["spans"]
    dev = sorted(sp, key=lambda n: -sp[n]["device_s"])[:top]
    idle = sorted((n for n in sp if sp[n]["idle_s"]),
                  key=lambda n: -sp[n]["idle_s"])[:top]
    return ("[spans] device " + ", ".join(
        f"{n} {sp[n]['device_s']:.4f} s ({sp[n]['calls']})" for n in dev)
        + f"; idle {red['idle_s']:.4f} s: " + ", ".join(
            f"{n} {sp[n]['idle_s']:.4f} s" for n in idle)
        + f"; placed by stream order {red['by_stream_order']}")
