"""The benchmark of lighthouse_tpu_torch on one NVIDIA GPU (see run.py)."""
