"""driver_share (drivers): the device time of the operations launched
outside every ``es.linear.solve`` span of the port in the profiled solve,
over all of its device time, in %: the driver's own work (extending and
orthogonalizing the subspace, the Rayleigh-Ritz step).  Nothing where the
trace holds no device time or no linear solve."""

from ..harness.spans import device_s


def read(record):
    red = record["spans"]
    if not red or not red["device_s"] \
            or "es.linear.solve" not in red["spans"]:
        return None
    return 100.0 * device_s(red, outside=["es.linear.solve"]) \
        / red["device_s"]
