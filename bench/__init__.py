"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one H100.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json``; ``bench/README.md`` says how
the harness finds a cell's files and how to add one.
"""
