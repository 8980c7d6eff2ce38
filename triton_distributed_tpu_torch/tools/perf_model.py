"""Roofline model of the card (counterpart of
``triton_distributed_tpu/tools/perf_model.py``; only ``gemm_sol_ms`` is
ported, with the H100's published peaks in place of the TPU's).

The peaks are NVIDIA's data sheet for the H100 SXM at its 700 W power
limit, dense (no sparsity): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s
f32 outside them, 3.35 TB/s of HBM3.  A card set below 700 W runs slower
under load; a roofline share is stated against these peaks with the card's
power limit beside it.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    bf16_tflops: float
    f32_tflops: float
    hbm_gbps: float

    def tflops(self, dtype) -> float:
        return self.f32_tflops if dtype == torch.float32 else self.bf16_tflops


H100_SXM = ChipSpec("NVIDIA H100 80GB HBM3", bf16_tflops=989.0,
                    f32_tflops=67.0, hbm_gbps=3350.0)


def gemm_sol_ms(m: int, n: int, k: int, dtype=torch.bfloat16) -> float:
    """Roofline time of C = A @ B in ms: max(flops / peak, bytes / HBM
    rate), the counts from ``obs.costs.matmul``."""
    from ..obs import costs

    return costs.sol_ms(costs.matmul(m, n, k, dtype, dtype), dtype)
