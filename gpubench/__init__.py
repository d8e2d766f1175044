"""The benchmark of daam_tpu_torch on an NVIDIA H100 (see BENCHMARK.json)."""
