"""op_ms_per_apply (operators & kernels): the device time of the
operations launched inside ``op.apply`` ranges in the profiled solve, over
its applies, in ms.  Nothing where the trace holds no device time."""


def read(record):
    p = record["profile"]
    if not p or not p["applies"] or not p["op_device_s"]:
        return None
    return p["op_device_s"] / p["applies"] * 1e3
