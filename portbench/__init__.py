"""The benchmark of robustsq_whisper_torch (see BENCHMARK.json and run.py)."""
