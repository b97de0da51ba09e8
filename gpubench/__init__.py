"""The benchmark of `pointnerf_tpu_torch` on an NVIDIA H100 (see run.py)."""
