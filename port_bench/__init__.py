"""Benchmark of the PyTorch / CUDA port (txr_torch) on one card."""
