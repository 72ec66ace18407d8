"""navbench: the benchmark of the PyTorch / CUDA port (`dyobav_tpu_torch`).

`python3 navbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once on a CUDA card.
"""
