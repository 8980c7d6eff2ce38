"""RMSNorm (counterpart of ``triton_distributed_tpu/layers/norm.py``)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor | None = None,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis, computed in f32 (the scale multiplies the
    normalized value in f32) and cast back to ``x``'s dtype."""
    xf = x.float()
    out = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)
