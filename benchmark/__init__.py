"""The benchmark of halo2_tpu_torch (the PyTorch and CUDA port) on one card.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line; see ``run.py``.
"""
