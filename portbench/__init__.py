"""The benchmark of ``hpbandster_tpu_torch`` on one NVIDIA H100.

``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Configurations, traffic mixes and per-layer metric readers are
files of their own under ``configs/``, ``traffic/`` and ``metrics/``,
found by the names in ``BENCHMARK.json``; ``reference/`` holds the plain
reference that decides ``correct``.
"""
