"""op_roofline (operators & kernels): the least time of the profiled
solve's applies at their shapes (the configuration's ``apply_bound_s``,
from the shapes alone, on the card's rates in harness/peaks.py) over the
device time of the operations launched inside their ``op.apply`` ranges,
in %.  Nothing where the trace holds no device time."""


def read(record):
    p = record["profile"]
    if not p or not p["op_device_s"]:
        return None
    return 100.0 * p["op_bound_s"] / p["op_device_s"]
