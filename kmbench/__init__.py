"""kmbench: the benchmark of kmcuda_torch on one CUDA card.

Run a cell as ``python3 kmbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout; the cells are
listed in ``BENCHMARK.json``.
"""
