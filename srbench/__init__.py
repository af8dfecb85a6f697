"""The benchmark of tpusr_torch on one H100: ``python -m srbench.run``.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:
``configs/<config>.json``, ``workloads/<cell>.json`` (which names its
driver, ``drivers/<driver>.py``), ``metrics/<metric>.py``. The yardstick
(peaks, operation and byte counts), the traffic and image generators,
the plain references and the comparisons that decide ``correct`` live
here too, apart from the program under test.
"""
