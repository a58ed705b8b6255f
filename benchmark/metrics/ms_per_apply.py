"""ms_per_apply (solve loop): the walls of the traced run's solves that
were not profiled over their applies, in ms: the apply and everything
around it (the MINRES recurrence, vector work, host reads, launch
gaps)."""


def read(record):
    runs = [s for s in record["solves"] if not s["profiled"]]
    applies = sum(s["applies"] for s in runs)
    if not applies:
        return None
    return sum(s["wall_s"] for s in runs) / applies * 1e3
