"""One module per metric, named as in ``BENCHMARK.json``: its ``UNIT``,
``BETTER`` and ``SOURCE``, per-layer ones their ``LAYER`` and ``MOVES``,
and ``read(record)``, the number from a run's record or None where the
run has nothing to read it from (``benchmark.core.run`` makes the
record)."""
