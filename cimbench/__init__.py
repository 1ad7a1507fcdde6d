"""The benchmark of the PyTorch/CUDA port of Eva-CiM (``repro_torch``).

``python3 cimbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line; see ``cimbench/README.md``.
"""
