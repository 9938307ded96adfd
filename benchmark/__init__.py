"""The benchmark of pbrt_tpu_torch (see BENCHMARK.json and PERF.md)."""
