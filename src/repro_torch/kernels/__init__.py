"""Attention kernels: plain PyTorch versions and hand-written CUDA kernels."""
