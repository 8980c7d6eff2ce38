"""Flop and byte counts of a kernel call, and its roofline time on the card
(counterpart of ``triton_distributed_tpu/obs/costs.py``; the ``matmul``
calculator, the overlapped GEMMs' and ``sol_ms`` are ported, the others come
with the kernels they describe).  Counts are per rank, as JAX's; a call on n
co-located ranks does n times the work on one card."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class KernelCost:
    flops: float
    bytes_accessed: float
    wire_bytes: float = 0.0   # bytes a rank sends its peers


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def matmul(m: int, n: int, k: int, dtype, out_dtype=None) -> KernelCost:
    """C[m, n] = A[m, k] @ B[k, n]: each operand read once, C written once."""
    ib, ob = _itemsize(dtype), _itemsize(out_dtype or dtype)
    return KernelCost(flops=2 * m * n * k,
                      bytes_accessed=ib * (m * k + k * n) + ob * m * n)


def ag_gemm(m_loc: int, k: int, n_loc: int, num_ranks: int, dtype,
            out_dtype=None) -> KernelCost:
    """AllGather-GEMM per rank: the product over the whole gathered A
    (n m_loc rows), the gathered copy written, and (n - 1) A shards sent on
    the ring (JAX ``costs.ag_gemm``)."""
    n = num_ranks
    mm = matmul(n * m_loc, n_loc, k, dtype, out_dtype)
    wire = (n - 1) * m_loc * k * _itemsize(dtype)
    return KernelCost(flops=mm.flops,
                      bytes_accessed=mm.bytes_accessed + n * m_loc * k * _itemsize(dtype) + wire,
                      wire_bytes=wire)


def gemm_rs(m_loc: int, k_loc: int, n_dim: int, num_ranks: int, dtype,
            out_dtype=None) -> KernelCost:
    """GEMM-ReduceScatter per rank: n chunk products over the local K shard,
    the travelling partial's n - 1 adds, each forwarded partial one hop
    (JAX ``costs.gemm_rs``)."""
    n = num_ranks
    ob = _itemsize(out_dtype or dtype)
    mm = matmul(n * m_loc, n_dim, k_loc, dtype, out_dtype)
    wire = (n - 1) * m_loc * n_dim * ob
    return KernelCost(flops=mm.flops + (n - 1) * m_loc * n_dim,
                      bytes_accessed=mm.bytes_accessed + 2 * (n - 1) * m_loc * n_dim * ob + wire,
                      wire_bytes=wire)


def gemm_ar(m_loc: int, k_loc: int, n_dim: int, num_ranks: int, dtype,
            out_dtype=None) -> KernelCost:
    """GEMM-AllReduce per rank: the GEMM-RS phase plus the AllGather ring
    that returns every reduced chunk to every rank (JAX ``costs.gemm_ar``)."""
    n = num_ranks
    ob = _itemsize(out_dtype or dtype)
    rs = gemm_rs(m_loc, k_loc, n_dim, n, dtype, out_dtype)
    ag_wire = (n - 1) * m_loc * n_dim * ob
    return KernelCost(flops=rs.flops,
                      bytes_accessed=rs.bytes_accessed + 2 * ag_wire,
                      wire_bytes=rs.wire_bytes + ag_wire)


def sol_ms(cost: KernelCost, dtype=torch.bfloat16) -> float:
    """Roofline time of ``cost`` on one card, in ms: the larger of the flops
    over the tensor-core (or, for f32, the FMA) peak and the bytes over the
    memory rate (``tools.perf_model.H100_SXM``, the card the port is built
    for)."""
    from ..tools import perf_model

    spec = perf_model.H100_SXM
    t_flops = cost.flops / (spec.tflops(dtype) * 1e12)
    t_mem = cost.bytes_accessed / (spec.hbm_gbps * 1e9)
    return max(t_flops, t_mem) * 1e3
