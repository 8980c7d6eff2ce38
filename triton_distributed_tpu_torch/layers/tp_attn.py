"""Attention-layer parameters at tp = 1 (counterpart of
``triton_distributed_tpu/layers/tp_attn.py``).

``wqkv`` keeps the JAX rank-blocked column layout ``[q_r | k_r | v_r]``
(``tp_attn.py:71-84``); at tp = 1 that is plain ``[q | k | v]``.  The forward
passes live in ``models/qwen.py``, where the KV cache is owned.
"""

from __future__ import annotations

import dataclasses

import torch

from .tp_mlp import fuse_column_shards


@dataclasses.dataclass
class TPAttnParams:
    """wqkv: (K, (H + 2*Hkv) * D) rank-blocked [q_r | k_r | v_r];
    wo: (H*D, K); q_norm/k_norm: (D,) or None."""

    wqkv: torch.Tensor
    wo: torch.Tensor
    q_norm: torch.Tensor | None
    k_norm: torch.Tensor | None


def init_attn(generator: torch.Generator, hidden: int, num_heads: int,
              num_kv_heads: int, head_dim: int, *, qk_norm: bool = True,
              dtype=torch.bfloat16, scale: float = 0.02,
              device=None) -> TPAttnParams:
    """N(0, scale) projections drawn from ``generator`` and unit QK norms
    (reference ``tp_attn.py:86-98``)."""
    def normal(shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device) * scale

    h, hk, d = num_heads, num_kv_heads, head_dim
    wq = normal((hidden, h * d))
    wk = normal((hidden, hk * d))
    wv = normal((hidden, hk * d))
    wo = normal((h * d, hidden))
    qn = kn = None
    if qk_norm:
        qn = torch.ones((d,), dtype=dtype, device=device)
        kn = torch.ones((d,), dtype=dtype, device=device)
    return TPAttnParams(wqkv=fuse_column_shards([wq, wk, wv], 1), wo=wo,
                        q_norm=qn, k_norm=kn)
