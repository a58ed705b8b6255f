"""applies_per_solve (drivers): the operator applies of a solve, counted by
the traced run's ``op.apply`` wrapper, over its solves that were not
profiled."""


def read(record):
    runs = [s for s in record["solves"] if not s["profiled"]]
    if not runs:
        return None
    return sum(s["applies"] for s in runs) / len(runs)
