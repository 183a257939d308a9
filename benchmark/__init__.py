"""The benchmark of ``robustbnns_tpu_torch`` on one NVIDIA H100 (``BENCHMARK.json``)."""
