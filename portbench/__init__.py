"""The benchmark of ``vqvae_tpu_torch`` on one NVIDIA H100.

``python3 portbench/run.py --workload <config>.<traffic> --seed <n>
--seconds <s> --trace <0|1>`` from the repository root runs one cell of
``BENCHMARK.json`` and prints one JSON line. Everything a cell needs is
found by name: ``configs/<config>.json`` (the sizes, with the plain
reference they run against), ``traffic/<traffic>.json`` (the stage driver
and its parameters), ``limits/<workload>.json`` (the correctness limits)
and ``metrics/<metric>.py`` (one reader per per-layer metric).

The yardstick lives here and nowhere in the program: the seeded inputs
(``inputs``), the published peaks and the operation counts
(``yardstick``), the trace reduction (``tracing``), the plain references
(``reference/``) and the comparisons that decide ``correct``.
"""
