"""The benchmark of ``eigensolvers_tpu_torch`` on one NVIDIA GPU.

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one configuration, traffic mix,
cell or per-layer metric sits in a file of its own, found by its name:
``configs/<config>.json`` (sizes, with the control's and the tests' own)
with ``configs/<config>.py`` (inputs and traffic hooks, plain
numpy/torch), ``configs/<config>_program.py`` (the system under test's
operator) and ``configs/<config>_ref.py`` (the plain reference);
``traffic/<mix>.json``, whose ``entry`` names ``entries/<entry>.py`` (the
port's entry point, called as a user calls it) and whose
``targets.pick`` names ``picks/<pick>.py`` (which returned eigenpairs are
held to which levels); ``limits/<cell>.json``; ``metrics/<metric>.py``
(a reader of the run's record).  ``configs/__init__.py`` gives the
contract of each.  Nothing here imports jax or ``eigensolvers_tpu``.
"""
