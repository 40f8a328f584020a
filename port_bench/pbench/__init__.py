"""The port's benchmark harness: everything ``port_bench/run.py`` drives.

``spec`` finds a cell's files by the names in ``BENCHMARK.json``;
``traffic`` and ``weights`` make its inputs and weights from ``--seed``;
``port`` holds what the program kinds
(``port_bench/programs/<kind>.py``, which build and time the program under
test, ``mmbidaf_tpu_torch``) share; ``trace`` reduces a profiler trace; ``counts``
holds the operation, byte and peak arithmetic; ``check`` compares the
timed outputs with ``port_bench/reference``; ``core`` runs one cell.
"""
