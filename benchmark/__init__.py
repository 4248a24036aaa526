"""The benchmark of SimWhisper-Codec's PyTorch port (``BENCHMARK.json``): see ``run.py``."""
