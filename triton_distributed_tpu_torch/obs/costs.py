"""Flop and byte counts of a kernel call, and its roofline time on the card
(counterpart of ``triton_distributed_tpu/obs/costs.py``; only the
``matmul`` calculator and ``sol_ms`` are ported, the others come with the
kernels they describe)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class KernelCost:
    flops: float
    bytes_accessed: float


def matmul(m: int, n: int, k: int, dtype, out_dtype=None) -> KernelCost:
    """C[m, n] = A[m, k] @ B[k, n]: each operand read once, C written once."""
    ib = torch.empty((), dtype=dtype).element_size()
    ob = torch.empty((), dtype=out_dtype or dtype).element_size()
    return KernelCost(flops=2 * m * n * k,
                      bytes_accessed=ib * (m * k + k * n) + ob * m * n)


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
