"""Dense SwiGLU MLP parameters and forward passes, at tp = 1 and on a mesh of
tp co-located ranks (counterpart of
``triton_distributed_tpu/layers/tp_mlp.py``).

The fused ``gate_up`` weight keeps the JAX rank-blocked column layout
``[gate_r | up_r]`` (``tp_mlp.py:77-80``); at tp = 1 that is plain
``[gate | up]`` and both products are ``torch.matmul`` (the JAX fused ops
are plain products on one device, ``ops/ag_gemm.py:316``,
``ops/gemm_rs.py:268``).  At tp = n the parameters are rank-stacked
(``core/mesh.py``): ``gate_up`` ``(n, K, 2I / n)``, rank r's ``[gate_r |
up_r]``, and ``down`` ``(n, I / n, K)``, rank r's rows.  :func:`forward`
brackets the activation with the AllGather-GEMM (K12) and the
GEMM-ReduceScatter (K13), :func:`forward_ar` runs the replicated column GEMM
and the GEMM-AllReduce (K14), as JAX's ``TPMLP.forward``/``forward_ar``
(``tp_mlp.py:132-150``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..core.mesh import TP_AXIS, Mesh


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


def reblock(columns: torch.Tensor, parts, n_from: int, n_to: int) -> torch.Tensor:
    """Columns fused for ``n_from`` ranks, re-fused for ``n_to``:
    ``columns`` (K, sum(parts)) holds n_from rank blocks, each ``[p0_r |
    p1_r | ...]`` with part j ``parts[j] / n_from`` wide; the result holds
    the same parts in n_to blocks.  The JAX ``wqkv`` and ``gate_up`` built at
    tp = 1 are ``[q | k | v]``, at tp = 4 ``[q_0 | k_0 | v_0 | q_1 | ...]``:
    the same shapes, other heads, so parameters cross between tp sizes only
    through this."""
    widths = [p // n_from for p in parts]
    blocks = columns.reshape(columns.shape[0], n_from, sum(widths)).split(widths, dim=-1)
    return fuse_column_shards([b.reshape(columns.shape[0], -1) for b in blocks], n_to)


def stack_columns(w: torch.Tensor, n: int) -> torch.Tensor:
    """(K, C) rank-blocked columns -> (n, K, C / n), rank r's block."""
    return w.reshape(w.shape[0], n, -1).permute(1, 0, 2).contiguous()


def stack_rows(w: torch.Tensor, n: int) -> torch.Tensor:
    """(R, K) rows -> (n, R / n, K), rank r's rows."""
    return w.reshape(n, -1, w.shape[1]).contiguous()


@dataclasses.dataclass
class TPMLPParams:
    """gate_up: (K, 2I) [gate | up]; down: (I, K).  At tp = n,
    rank-stacked: gate_up (n, K, 2I / n) [gate_r | up_r], down (n, I / n,
    K)."""

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
    return torch.matmul(act_combine(torch.matmul(x, p.gate_up)), p.down)


def shard_mlp(p: TPMLPParams, n: int) -> TPMLPParams:
    """tp = 1 parameters as rank-stacked shards of ``n`` ranks (JAX
    ``TPMLP.shard_params``)."""
    i2 = p.gate_up.shape[1]
    return TPMLPParams(gate_up=stack_columns(reblock(p.gate_up, [i2 // 2] * 2, 1, n), n),
                       down=stack_rows(p.down, n))


def act_combine(fused: torch.Tensor) -> torch.Tensor:
    """SwiGLU on rank-local ``[gate_r | up_r]`` columns (JAX
    ``TPMLP._act_combine``)."""
    gate, up = fused.chunk(2, dim=-1)
    return F.silu(gate) * up


def replicated_column_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Replicated (M, K) activations times rank-stacked columns ``w`` (n, K,
    C): each rank's (M, C) product in x's dtype, rank-stacked (JAX
    ``replicated_column_gemm``).  One copy of ``x`` serves every rank, by
    broadcasting; at tp = 1 ``w`` is (K, C) and this is the plain product."""
    return torch.matmul(x, w)


def forward(p: TPMLPParams, x: torch.Tensor, mesh: Mesh, axis: str = TP_AXIS) -> torch.Tensor:
    """AG-GEMM, SwiGLU, GEMM-RS (JAX ``TPMLP.forward``): ``x`` rank-stacked
    (n, M / n, K) rows, the result the same."""
    from ..ops.ag_gemm import ag_gemm
    from ..ops.gemm_rs import gemm_rs

    return gemm_rs(act_combine(ag_gemm(x, p.gate_up, mesh, axis)), p.down, mesh, axis)


def forward_ar(p: TPMLPParams, x: torch.Tensor, mesh: Mesh, axis: str = TP_AXIS) -> torch.Tensor:
    """Replicated column GEMM, SwiGLU, GEMM-AR (JAX ``TPMLP.forward_ar``):
    ``x`` replicated (M, K), M divisible by n; the result (n, M, K), every
    rank's copy."""
    from ..ops.gemm_ar import gemm_ar

    return gemm_ar(act_combine(replicated_column_gemm(x, p.gate_up)), p.down, mesh, axis)
