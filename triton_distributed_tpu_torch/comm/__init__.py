"""Collectives on a mesh of co-located ranks, each a hand-written CUDA
kernel: AllGather (K9), ReduceScatter (K10) and AllReduce (K11)
(counterpart of ``triton_distributed_tpu/comm``; the all-to-all, the
hierarchical and the quantized collectives are not ported yet)."""

from .allgather import AllGatherMethod, all_gather, all_gather_ref, choose_method
from .allreduce import AllReduceConfig, AllReduceMethod, all_reduce, all_reduce_ref
from .reduce_scatter import ReduceScatterConfig, reduce_scatter, reduce_scatter_ref

__all__ = [
    "AllGatherMethod", "AllReduceConfig", "AllReduceMethod",
    "ReduceScatterConfig", "all_gather", "all_gather_ref", "all_reduce",
    "all_reduce_ref", "choose_method", "reduce_scatter", "reduce_scatter_ref",
]
