"""Attention ops of the port: plain PyTorch versions and CUDA kernels."""
