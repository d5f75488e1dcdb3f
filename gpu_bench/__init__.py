"""Benchmark of srbd_nmpc_tpu_torch on CUDA cards (see run.py)."""
