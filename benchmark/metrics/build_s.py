"""build_s (operators & kernels): the seconds of the program's operator
build in the run's set-up, its uploads to the card included: the port's
``es.build`` span (``models/op_parser.py::build_sop_operator``), read from
its counters after set-up (the record's ``setup_counts``), in which
set-up's build is the run's only one.  Nothing where the program has no
such counter."""


def read(record):
    build = record["setup_counts"].get("es.build")
    return None if build is None else build["seconds"]
