"""The benchmark's configurations, each in files of its own, found by its
name.  A configuration and its cells enter by new files and new entries
alone; no file already here changes.

The files of a configuration ``<name>``:

- ``configs/<name>.json``: its sizes as they are run, read whole by the
  hooks below; and beside them ``source``, ``reduced`` (with the reason
  for each cut), ``control`` (``{"sizes": {...}, "what": ...}``: the
  entries that switch on the program's own path one precision below the
  configuration's, the control of ``correct``) and ``tests``
  (``{"sizes": {...}, "why": ...}``: the entries that make it small
  enough for the CPU tests, every mix's levels still there);
- ``configs/<name>.py``, the inputs and traffic hooks, plain numpy and
  torch: ``inputs(sizes)`` (an object with ``n`` and ``dtype``),
  ``traffic_inputs(inp, traffic)``, ``guesses(inp, traffic, gen,
  device)``, ``apply_bound_s(inp, lanes, kind)`` (the least time of one
  apply, from the shapes alone) and ``reference(inp, device)`` (an object
  with ``apply(X)``, ``levels(count=None)`` and ``h_norm``);
- ``configs/<name>_program.py``, the system under test:
  ``operator(inp, device)`` (the port's operator, with ``matvec`` and
  ``matvec_lanes``) and ``port_applies(entry, status, report)`` (the
  port's own count of a solve's applies);
- ``configs/<name>_ref.py``, the plain reference: it imports nothing of
  the port, of JAX or of the JAX package, and takes nothing the program
  made.

The files of a cell ``<cell>``: ``traffic/<mix>.json`` (data: its
``entry`` names ``entries/<entry>.py``, its ``targets.pick`` names
``picks/<pick>.py``; a mix may serve many cells) and
``limits/<cell>.json`` (the limit of each number that ``correct``
compares).

The entries in ``BENCHMARK.json``: the configuration under ``configs``
(its ``file`` the JSON above), each cell under ``workloads`` (its
``config`` names the configuration; the cell's name need not start with
it), and the cell's name in the ``workloads`` list of each per-layer
metric that it reports.  A new metric is ``metrics/<metric>.py::
read(record)`` on the record that ``harness/core.py::run`` returns: each
solve's wall, answers, the wrapper's applies and shapes and the port's
counters' gain over it (``counts``), the port's counters after set-up
(``setup_counts``), and in the traced run the profiled solve reduced by
``op.apply`` ranges (``profile``) and by the port's ``es.*`` spans
(``spans``).
"""
