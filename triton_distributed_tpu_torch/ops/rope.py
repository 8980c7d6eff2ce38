"""Rotary position embeddings, rotate-half convention (GPT-NeoX / LLaMA /
Qwen), computed in f32 and cast back (counterpart of
``triton_distributed_tpu/ops/rope.py``).  Plain tensor code: it is elementwise
and stays beside the projections rather than in a kernel of its own."""

from __future__ import annotations

import torch


def rope_freqs(positions: torch.Tensor, head_dim: int, *,
               theta: float = 10_000.0, dtype=torch.float32):
    """(cos, sin) tables of shape ``positions.shape + (head_dim // 2,)``."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=positions.device) / half
    inv_freq = 1.0 / (theta ** exponent)
    angles = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` (..., seq, head_dim) by tables (..., seq, head_dim // 2)
    that broadcast over the leading axes."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope_at(x: torch.Tensor, positions: torch.Tensor, *,
                  theta: float = 10_000.0) -> torch.Tensor:
    """Rotate ``x`` (..., seq, head_dim) at absolute ``positions`` (seq,) or
    any shape that broadcasts against ``x.shape[:-1]``."""
    cos, sin = rope_freqs(positions, x.shape[-1], theta=theta)
    return apply_rope(x, cos, sin)
