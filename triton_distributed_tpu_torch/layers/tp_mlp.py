"""Dense SwiGLU MLP parameters at tp = 1 (counterpart of
``triton_distributed_tpu/layers/tp_mlp.py``).

The JAX layer brackets its activation with AllGather-GEMM and
GEMM-ReduceScatter; on one device both are a plain matrix product
(``ops/ag_gemm.py:316``, ``ops/gemm_rs.py:268``), which here is
``torch.matmul``.  The fused ``gate_up`` weight keeps the JAX rank-blocked
column layout ``[gate_r | up_r]`` so that tensor parallelism later changes no
layout.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


def fuse_column_shards(parts, n: int) -> torch.Tensor:
    """Fuse column-parallel weights into the per-rank-blocked layout:
    ``parts`` is a list of (K, I_j) tensors, each cut n ways by columns; the
    result (K, sum_j I_j) holds [p0_r0 | p1_r0 | ... | p0_r1 | p1_r1 | ...]
    (reference ``tp_mlp.py:77-80``)."""
    for p in parts:
        if p.shape[1] % n:
            raise ValueError(f"column count {p.shape[1]} not divisible by {n} shards")
    blocks = []
    for r in range(n):
        for p in parts:
            i = p.shape[1] // n
            blocks.append(p[:, r * i:(r + 1) * i])
    return torch.cat(blocks, dim=1)


@dataclasses.dataclass
class TPMLPParams:
    """gate_up: (K, 2I) rank-blocked [gate_r | up_r]; down: (I, K)."""

    gate_up: torch.Tensor
    down: torch.Tensor


def init_mlp(generator: torch.Generator, hidden: int, intermediate: int, *,
             dtype=torch.bfloat16, scale: float = 0.02,
             device=None) -> TPMLPParams:
    """N(0, scale) weights drawn from ``generator`` (which must live on
    ``device``)."""
    def normal(shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device) * scale

    gate = normal((hidden, intermediate))
    up = normal((hidden, intermediate))
    down = normal((intermediate, hidden))
    return TPMLPParams(gate_up=fuse_column_shards([gate, up], 1), down=down)


def mlp_forward(p: TPMLPParams, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP on (M, K) activations; the products round to x's dtype
    after an f32 accumulation, as the JAX dots with an f32 result do."""
    fused = torch.matmul(x, p.gate_up)
    gate, up = fused.chunk(2, dim=-1)
    return torch.matmul(F.silu(gate) * up, p.down)
