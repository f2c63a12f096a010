"""The benchmark of the PyTorch and CUDA port (``repro_torch``): its
harness, traffic, counts, plain reference and metric readers.  Run a
cell with ``python3 bench/run.py --workload <name> --seed <n> --seconds
<s> --trace <0|1>`` from the repository's root (see README.md)."""
