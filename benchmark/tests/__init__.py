"""The benchmark's CPU tests (python -m pytest benchmark/tests -q)."""
