"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, per-layer metric
or kernel lives in a file of its own, found by the name ``BENCHMARK.json``
gives it (``bench/spec.py``).  The plain reference in ``bench/reference/``
imports nothing of the port.
"""
