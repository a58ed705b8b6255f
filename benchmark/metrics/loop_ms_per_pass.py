"""loop_ms_per_pass (solve loop): the device time of the operations
launched inside the port's ``es.minres.pass`` spans and outside their
``es.apply`` spans in the profiled solve, over its passes, in ms: the
MINRES recurrence's own vector work.  Nothing where the trace holds no
device time or no pass."""

from ..harness.spans import device_s


def read(record):
    red = record["spans"]
    if not red or not red["device_s"]:
        return None
    passes = red["spans"].get("es.minres.pass", {}).get("calls")
    if not passes:
        return None
    return device_s(red, "es.minres.pass", ["es.apply"]) / passes * 1e3
