"""The benchmark of the PyTorch and CUDA port, `space_gym_torch`, on one H100.

`python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace
<0|1>` runs one cell (benchmark/harness.py); benchmark/registry.py says how
configurations, traffic mixes, cells, metrics and modes are found by name.
"""
