"""MoE MLP layer: top-k routed SwiGLU experts under the TP strategy at one
rank (counterpart of ``triton_distributed_tpu/layers/moe.py``).

Prefill (:meth:`MoEMLP.forward_tp`) and a decode step
(:meth:`MoEMLP.forward_replicated`) compute one function at one rank: route
and sort the tokens, the grouped up-projection, the activation, the grouped
down-projection, and the weighted top-k fold.  Every expert product is
``ops.group_gemm.grouped_matmul`` (K5 on the card); the router is a plain
product.  The dtypes follow JAX: router logits in the model dtype, softmax,
top-k and renormalization in f32, the routing weights cast to the expert
output's dtype in the fold, the result in x's dtype.

At one rank the collectives of the TP strategy (JAX's ``ag_group_gemm``,
``moe_reduce_rs`` and the decode ``psum``) gather and reduce nothing, so
both entry points run one body.  More ranks, with those collectives, the EP
strategy (``forward_ep``) and the fp8 wire belong to later slices of the
port and raise.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..ops.group_gemm import grouped_matmul
from ..ops.moe_utils import (
    flatten_topk,
    sort_by_expert,
    topk_route,
    unsort_combine,
)


@dataclasses.dataclass
class MoEParams:
    """router: (K, E); w_up: (E, K, F), or (E, K, 2F) as ``[gate | up]``
    when the layer runs ``swiglu``; w_dn: (E, F, K)."""

    router: torch.Tensor
    w_up: torch.Tensor
    w_dn: torch.Tensor


@dataclasses.dataclass(frozen=True)
class MoEMLP:
    """``swiglu=False``: each expert is one up-projection with SiLU on its
    output; ``swiglu=True``: gated experts, ``w_up`` holding ``[gate | up]``
    (Qwen3-MoE).  ``world_size`` above 1 and ``fp8_wire`` raise: the TP
    strategy at one rank is what this slice serves."""

    num_experts: int
    top_k: int = 2
    swiglu: bool = False
    renormalize: bool = True
    fp8_wire: bool | str = False
    world_size: int = 1

    def __post_init__(self):
        if self.fp8_wire:
            raise NotImplementedError(
                "the fp8 wire of the EP all-to-all belongs to the EP slice of "
                "the port")
        if self.world_size != 1:
            raise NotImplementedError(
                f"MoE over {self.world_size} ranks belongs to the multi-GPU "
                "slice of the port")

    def _combine(self, h: torch.Tensor) -> torch.Tensor:
        """The activation after the up-projection: SiLU, or the gated split
        ``silu(gate) * up`` of ``[gate | up]``."""
        if not self.swiglu:
            return F.silu(h)
        g, u = h.chunk(2, dim=-1)
        return F.silu(g) * u

    # -- parameter construction ------------------------------------------

    def fuse_expert_gate_up(self, gate: torch.Tensor,
                            up: torch.Tensor) -> torch.Tensor:
        """Per-expert (E, K, F) gate and up as the (E, K, 2F) ``[gate | up]``
        layout: the JAX rank-blocked ``[gate_r | up_r]`` at one rank."""
        return torch.cat([gate, up], dim=-1)

    def init(self, generator: torch.Generator, hidden: int, ffn: int, *,
             dtype=torch.bfloat16, scale: float = 0.02,
             device=None) -> MoEParams:
        """N(0, ``scale``) router and expert weights drawn from
        ``generator`` (which must live on ``device``), made there."""
        e = self.num_experts

        def normal(shape):
            return torch.randn(shape, generator=generator, dtype=dtype,
                               device=device) * scale

        router = normal((hidden, e))
        if self.swiglu:
            w_up = self.fuse_expert_gate_up(normal((e, hidden, ffn)),
                                            normal((e, hidden, ffn)))
        else:
            w_up = normal((e, hidden, ffn))
        return MoEParams(router=router, w_up=w_up,
                         w_dn=normal((e, ffn, hidden)))

    # -- forward ----------------------------------------------------------

    def _route_and_sort(self, x: torch.Tensor, router: torch.Tensor):
        """Route the tokens, replicate them per choice, sort by expert.
        Returns (x_sorted, splits, weights in (token, choice) order,
        unsort)."""
        eid, wts = topk_route(torch.matmul(x, router), self.top_k,
                              renormalize=self.renormalize)
        xr, eflat, wflat = flatten_topk(x, eid, wts)
        xs, splits, unsort = sort_by_expert(xr, eflat, self.num_experts)
        return xs, splits, wflat, unsort

    def _forward(self, params: MoEParams, x: torch.Tensor) -> torch.Tensor:
        """Route -> grouped up-projection -> activation -> grouped
        down-projection -> weighted top-k fold, in x's dtype."""
        x_sorted, splits, wflat, unsort = self._route_and_sort(x, params.router)
        h = self._combine(grouped_matmul(x_sorted, params.w_up, splits))
        y = grouped_matmul(h, params.w_dn, splits)
        return unsort_combine(y, unsort, wflat, self.top_k).to(x.dtype)

    def forward_tp(self, params: MoEParams, x: torch.Tensor) -> torch.Tensor:
        """Prefill: (M, K) -> (M, K) in x's dtype.  At one rank the
        AllGather before the up-projection and the ReduceScatter after the
        fold are the identity."""
        return self._forward(params, x)

    def forward_replicated(self, params: MoEParams,
                           x: torch.Tensor) -> torch.Tensor:
        """Decode: (B, K) -> (B, K) in x's dtype.  At one rank the psum of
        the partial sums is the identity."""
        return self._forward(params, x)
