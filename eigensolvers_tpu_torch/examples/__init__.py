"""The example drivers on the port: each ``X.py`` is the JAX package's
``examples/X.py``, run as ``python -m eigensolvers_tpu_torch.examples.X``
on the card (``--cpu`` for the CPU), with a ``run(...)`` that returns its
numbers and outputs under ``--out`` (default ``build/artifacts/``)."""
