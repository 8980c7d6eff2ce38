"""Attention and fused decode kernels with their plain PyTorch versions,
and RoPE."""
