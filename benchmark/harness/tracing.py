"""The traced run's instruments, all in the benchmark's own files: a
counting ``record_function("op.apply")`` range around the operator
instance's ``matvec`` and ``matvec_lanes`` (the only ways the port's
solvers reach the operator), and the reduction of one profiled solve's
``torch.profiler`` trace to device busy time, the device time of the
kernels launched inside ``op.apply`` ranges, the top device operations and
the longest idle gaps by what the host was doing.  A device operation
belongs to the ``op.apply`` range in which the host made the runtime call
that launched it (the call's correlation id); one whose call the trace
does not hold belongs to a range that lies between the launches of the
operations before and after it on the stream.""" 

import bisect
import collections

import torch

APPLY = "op.apply"


class ApplyCounter:
    """Wraps ``op.matvec`` and ``op.matvec_lanes`` on the instance (its
    type stays as it is); counts the outermost calls, and while
    ``shapes`` is a list (the profiled solve) puts each in an ``op.apply``
    range and records its (lanes, type).  Outside the profiled solve it
    only counts: a range costs tens of microseconds of host time an
    apply."""

    def __init__(self, op):
        self.op, self.count, self.depth, self.shapes = op, 0, 0, None
        for name, single in (("matvec", True), ("matvec_lanes", False)):
            setattr(op, name, self._wrap(getattr(op, name), single))

    def _wrap(self, fn, single):
        def apply(x):
            if self.depth:          # inside an apply (a default lane stack)
                return fn(x)
            self.depth = 1
            try:
                if self.shapes is None:
                    y = fn(x)
                else:
                    with torch.profiler.record_function(APPLY):
                        y = fn(x)
            finally:
                self.depth = 0
            self.count += 1
            if self.shapes is not None:
                wide = torch.promote_types(x.dtype, self.op.dtype)
                self.shapes.append((1 if single else x.shape[0],
                                    "f64" if wide == torch.float64
                                    else "f32"))
            return y
        return apply

    def remove(self):
        del self.op.matvec, self.op.matvec_lanes


def wrapper_shapes(shapes):
    """An ``ApplyCounter``'s (lanes, "f64" | "f32") list in the form of
    ``spans.program_shapes``: {"<lanes>x<dtype>": applies}."""
    return dict(collections.Counter(
        f"{m}x{'float64' if d == 'f64' else 'float32'}" for m, d in shapes))


def profiler(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=False,
                                  with_stack=False)


def _merge(intervals):
    """Union of (start, end) intervals: (merged list, covered length)."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out, sum(e - s for s, e in out)


def reduce_profile(prof, top=10):
    """From one profiled solve: device busy seconds (union of every device
    operation's interval), the device seconds of the operations launched
    inside ``op.apply`` ranges, the top device operations by time, the
    longest idle gaps (summed by the host operation that covered the gap,
    else the one that had last started), and event counts."""
    from torch.autograd import DeviceType
    starts, ends = [], []           # op.apply ranges on the host
    host = []                       # (start, end, name) of host operations
    calls = {}                      # runtime call's id -> its start
    dev = []                        # (start, end, name, id)
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        if e.device_type() == DeviceType.CPU:
            name, end = e.name(), s + e.duration_ns()
            if e.linked_correlation_id():
                # a runtime call (a launch): its device operation shares
                # its correlation id
                calls[e.correlation_id()] = s
            if name == APPLY:
                starts.append(s)
                ends.append(end)
            else:
                host.append((s, end, name))
        elif e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            dev.append((s, s + e.duration_ns(), e.name(), e.correlation_id()))
    order = sorted(range(len(starts)), key=starts.__getitem__)
    starts = [starts[i] for i in order]
    ends = [ends[i] for i in order]
    dev.sort()
    # each device operation's launch time on the host: its runtime call's;
    # None where the trace has no call for it (a kernel launched through a
    # library's own static CUDA runtime, as the port's ctypes kernels are)
    launch = [calls.get(corr) for _, _, _, corr in dev]

    def in_apply(t0, t1):
        """Whether an op.apply range overlaps the host interval (t0, t1)."""
        i = bisect.bisect_left(starts, t1) - 1
        return i >= 0 and ends[i] > t0

    # One stream runs its operations in launch order: an operation whose
    # launch is unknown was launched between the launches of the known
    # operations before and after it on the device, and belongs to an
    # op.apply range if one lies in that interval.
    prev = [None] * len(dev)
    last = float("-inf")
    for k, t in enumerate(launch):
        prev[k] = last
        if t is not None:
            last = t
    op_ns, nxt = 0, float("inf")
    by_order = 0
    for k in range(len(dev) - 1, -1, -1):
        s, e, _, _ = dev[k]
        t = launch[k]
        if t is not None:
            if in_apply(t, t):
                op_ns += e - s
            nxt = t
        else:
            by_order += 1
            if in_apply(prev[k], nxt):
                op_ns += e - s
    by_name = collections.Counter()
    for s, e, name, _ in dev:
        by_name[name[:160]] += e - s
    merged, busy_ns = _merge([(s, e) for s, e, *_ in dev])
    host.sort()
    hstarts = [h[0] for h in host]
    gaps = collections.Counter()
    for (s0, e0), (s1, _) in zip(merged, merged[1:]):
        mid = 0.5 * (e0 + s1)
        i = bisect.bisect_right(hstarts, mid) - 1
        label = "host: (none)"
        for j in range(i, max(i - 64, -1), -1):
            if host[j][1] >= mid:
                label = f"host: {host[j][2][:120]}"
                break
        else:
            if i >= 0:
                label = f"host, after: {host[i][2][:120]}"
        gaps[label] += s1 - e0
    return {"busy_s": busy_ns / 1e9, "op_device_s": op_ns / 1e9,
            "device_ops": [[n, t / 1e9] for n, t in by_name.most_common(top)],
            "idle_gaps": [[n, t / 1e9] for n, t in gaps.most_common(top)],
            "events": {"host": len(host), "device": len(dev),
                       "by_launch_call": len(dev) - by_order,
                       "by_stream_order": by_order,
                       "apply_ranges": len(starts)}}
