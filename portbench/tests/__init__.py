"""CPU and card tests of the benchmark (run: python -m pytest portbench/tests)."""
