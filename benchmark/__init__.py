"""The benchmark of ``arcanefem_tpu_torch`` on one NVIDIA card.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; README.md says how
the harness finds its configurations, cells, traffic and metrics by name.
"""
