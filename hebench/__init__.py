"""hebench: the benchmark of mkhe_tpu_torch, the PyTorch and CUDA port.

    python3 hebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See README.md for the layout of its data files and how to add to them.
"""
