"""The benchmark's general machinery: the spec, seeds, seeded weights, the
timed window, the trace reduction, the counting functions and the result
line.  What belongs to one configuration, traffic mix or metric lives in
its own file under ``configs/``, ``traffic/``, ``kinds/``, ``metrics/``,
``reference/`` and ``limits/``, found by the names in ``BENCHMARK.json``.
"""
