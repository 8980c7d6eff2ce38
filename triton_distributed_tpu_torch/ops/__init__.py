"""Attention kernels with their plain PyTorch versions, and RoPE."""
