"""host_reads_per_solve (solve loop): the port's blocking device-to-host
reads in a solve (its ``es.read`` counter, ``utils/profiling.py::
to_host``), over the traced run's solves that were not profiled.  Nothing
where the program counted nothing in them."""


def read(record):
    runs = [s for s in record["solves"] if not s["profiled"]]
    if not any(s["counts"] for s in runs):
        return None
    return sum(s["counts"].get("es.read", {}).get("calls", 0)
               for s in runs) / len(runs)
