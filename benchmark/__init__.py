"""The benchmark of attentive_dfprior_tpu_torch on one NVIDIA H100
(``BENCHMARK.json``; ``python3 benchmark/run.py``)."""
