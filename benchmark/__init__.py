"""The benchmark of tcs_tpu_torch: see BENCHMARK.json and PERF.md."""
