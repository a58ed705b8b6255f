"""device_idle (device): 1 - (union of the device operations' intervals) /
wall over the profiled solve, in %.  Nothing where the trace holds no
device time."""


def read(record):
    p = record["profile"]
    if not p or not p["busy_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["wall_s"])
