"""Attention-layer parameters at tp = 1 and on a mesh of tp co-located ranks
(counterpart of ``triton_distributed_tpu/layers/tp_attn.py``).

``wqkv`` keeps the JAX rank-blocked column layout ``[q_r | k_r | v_r]``
(``tp_attn.py:71-84``); at tp = 1 that is plain ``[q | k | v]``.  At tp = n
the parameters are rank-stacked: ``wqkv`` ``(n, K, (H + 2 Hkv) D / n)``,
rank r's ``[q_r | k_r | v_r]`` (its H / n query and Hkv / n kv heads, in
global head order), ``wo`` ``(n, H D / n, K)``; the qk norms stay one copy.
The forward passes live in ``models/qwen.py``, where the KV cache is owned;
:func:`split_heads` is the per-rank head split they share (JAX
``tp_attn.py:112-120``).
"""

from __future__ import annotations

import dataclasses

import torch

from .tp_mlp import fuse_column_shards, reblock, stack_columns, stack_rows


@dataclasses.dataclass
class TPAttnParams:
    """wqkv: (K, (H + 2*Hkv) * D) [q | k | v]; wo: (H*D, K); q_norm/k_norm:
    (D,) or None.  At tp = n wqkv and wo are rank-stacked (module
    docstring)."""

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


def shard_attn(p: TPAttnParams, n: int, num_heads: int, num_kv_heads: int,
               head_dim: int) -> TPAttnParams:
    """tp = 1 parameters as rank-stacked shards of ``n`` ranks (JAX
    ``TPAttn.shard_params``)."""
    parts = [num_heads * head_dim, num_kv_heads * head_dim, num_kv_heads * head_dim]
    return TPAttnParams(wqkv=stack_columns(reblock(p.wqkv, parts, 1, n), n),
                        wo=stack_rows(p.wo, n), q_norm=p.q_norm, k_norm=p.k_norm)


def split_heads(qkv: torch.Tensor, seq: int, heads: int, kv_heads: int, head_dim: int):
    """A rank's ``[q | k | v]`` projection of (B' * S) rows, batch-major,
    as q (B', heads, S, D) and k, v (B', kv_heads, S, D).  B' may fold the
    ranks of a mesh into the batch (rank-major): the heads are each rank's."""
    d = head_dim
    q, k, v = qkv.reshape(-1, seq, qkv.shape[-1]).split(
        [heads * d, kv_heads * d, kv_heads * d], dim=-1)
    b = q.shape[0]
    return (q.reshape(b, seq, heads, d).transpose(1, 2),
            k.reshape(b, seq, kv_heads, d).transpose(1, 2),
            v.reshape(b, seq, kv_heads, d).transpose(1, 2))
