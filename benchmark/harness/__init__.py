"""The benchmark's harness: cells, windows, traces, rooflines and checks.

Everything that belongs to one configuration, traffic mix or metric lives
in a file of its own (``configs/``, ``traffic/``, ``metrics/``,
``limits/``), found by the name ``BENCHMARK.json`` gives it; the drivers
of the traffic kinds are in ``drivers/``. See ``README.md``.
"""
