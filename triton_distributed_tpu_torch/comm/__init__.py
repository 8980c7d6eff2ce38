"""Collectives on a mesh of co-located ranks, each a hand-written CUDA
kernel: AllGather (K9), ReduceScatter (K10), AllReduce (K11) and the EP
all-to-all (K17; its quantized wire packs with K18) (counterpart of
``triton_distributed_tpu/comm``; the hierarchical collectives and the
quantized AllGather, ReduceScatter and AllReduce are not ported yet)."""

from .allgather import AllGatherMethod, all_gather, all_gather_ref, choose_method
from .all_to_all import AllToAllConfig, ep_combine, ep_combine_ref, ep_dispatch, ep_dispatch_ref
from .allreduce import AllReduceConfig, AllReduceMethod, all_reduce, all_reduce_ref
from .reduce_scatter import ReduceScatterConfig, reduce_scatter, reduce_scatter_ref

__all__ = [
    "AllGatherMethod", "AllReduceConfig", "AllToAllConfig", "ep_combine", "ep_combine_ref",
    "ep_dispatch", "ep_dispatch_ref", "AllReduceMethod",
    "ReduceScatterConfig", "all_gather", "all_gather_ref", "all_reduce",
    "all_reduce_ref", "choose_method", "reduce_scatter", "reduce_scatter_ref",
]
