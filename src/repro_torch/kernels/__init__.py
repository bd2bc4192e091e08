"""Attention kernels: hand-written CUDA for Hopper, their plain PyTorch
versions, and the ops that dispatch between them by device."""
