"""MoE MLP layer: top-k routed experts, under the TP strategy at one rank and
under the EP strategy on a mesh of co-located ranks (counterpart of
``triton_distributed_tpu/layers/moe.py``).

Every expert product is ``ops.group_gemm.grouped_matmul`` (K5 on the card);
the router is a plain product.  The dtypes follow JAX: router logits in the
model dtype, softmax, top-k and renormalization in f32, the routing weights
cast to the expert output's dtype in the fold, the result in x's dtype.

**TP strategy at one rank** (:meth:`MoEMLP.forward_tp`,
:meth:`MoEMLP.forward_replicated`): route and sort the tokens, the grouped
up-projection, the activation, the grouped down-projection, the weighted
top-k fold; JAX's ``ag_group_gemm``, ``moe_reduce_rs`` and decode ``psum``
gather and reduce nothing at one rank.  At tp > 1 the TP strategy raises
(ROADMAP A7).

**EP strategy** (``mesh`` with n ranks; rank r owns experts
``[r E/n, (r + 1) E/n)``, the rows ``w[r E/n:(r + 1) E/n]`` of the tp = 1
(E, ...) tensors, which the layer keeps as they are: nothing reads the
weights by rank, so there is no rank-shaped layout and no copy):

- :meth:`MoEMLP.forward_ep` (prefill, ``x`` row-sharded (n, M/n, K)): each
  rank routes and sorts its own rows (one sort of all ranks' rows keyed
  (rank, expert)); the EP all-to-all (K17) dispatches them to the owners'
  zones (with ``fp8_wire``, packed by K18 on both hops, through
  ``comm/quantized.py``'s wire halves);
  the zones are compacted expert-major, the grouped up-projection, SwiGLU
  and grouped down-projection run, the rows go back to the zone layout and
  K17 combines them; each rank unsorts and folds.  The ranks' compactions
  fold into one expert-major run over all E experts (rank r's local expert
  j is global expert r E/n + j, the weights' order), so each product is one
  K5 launch for every rank, as the attention folds the ranks into its
  batch.  Each row is multiplied by its own expert's weights only, so a
  rank's rows get what its own products would give.  Every routed row is
  real, so the compaction's first n T rows are all of them: K5 multiplies
  those and no zone padding (JAX multiplies its zero tail and zeroes the
  result).  Nothing reads a count on the host.
- :meth:`MoEMLP.forward_replicated_ep` (decode, ``x`` (B, K) one copy):
  every rank routes all B tokens the same way and keeps the rows of the
  experts it owns; JAX parks the others on local expert 0 with weight 0,
  computed and discarded.  The port leaves them out: the owners' rows of all
  ranks are one K5 run over the E experts, each rank's partial is the
  weighted fold of the choices it owns, in y's dtype, and the partials are
  summed in f32 and rounded once, as JAX's ``psum`` of bf16 partials does on
  the CPU (checked: every element of a 4 x 4096 sum equal).  A parked row
  adds exactly 0 to its rank's partial, so the result is unchanged
  (``tests/test_torch_ep.py``).

``fp8_wire``: True ships e4m3 on both hops of ``forward_ep``; "auto"
resolves as JAX's cold start does on a single-slice mesh (wire class "ici",
``calibrate.codec_pays`` False): co-located ranks have no wire for the
halved bytes to save, so the codec is off.  ``dcn_axis`` (the hierarchical
all-to-all) needs more than one card and is not a field here.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..comm.all_to_all import AllToAllConfig, ep_combine, ep_dispatch
from ..comm.quantized import combine_packed, dispatch_packed
from ..core.mesh import TP_AXIS, Mesh
from ..lang import quant
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
    when the layer runs ``swiglu``; w_dn: (E, F, K), at every tp and under
    either strategy."""

    router: torch.Tensor
    w_up: torch.Tensor
    w_dn: torch.Tensor


@dataclasses.dataclass(frozen=True)
class MoEMLP:
    """``swiglu=False``: each expert is one up-projection with SiLU on its
    output; ``swiglu=True``: gated experts, ``w_up`` holding ``[gate | up]``
    (Qwen3-MoE).  ``mesh``/``axis``: the EP ranks (None: one rank)."""

    num_experts: int
    top_k: int = 2
    swiglu: bool = False
    renormalize: bool = True
    fp8_wire: bool | str = False
    mesh: Mesh | None = None
    axis: str = TP_AXIS

    def __post_init__(self):
        if self.fp8_wire not in (True, False, "auto"):
            raise ValueError(f"fp8_wire must be True, False, or 'auto'; got {self.fp8_wire!r}")
        if self.num_experts % self.n:
            raise ValueError(f"num_experts = {self.num_experts} does not divide among "
                             f"{self.n} ranks")

    @property
    def n(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape[self.axis]

    def fp8_wire_enabled(self) -> bool:
        """Whether ``forward_ep`` ships e4m3: ``fp8_wire``, with "auto"
        resolved to False on co-located ranks (module docstring)."""
        return self.fp8_wire is True

    def _combine(self, h: torch.Tensor) -> torch.Tensor:
        """The activation after the up-projection: SiLU, or the gated split
        ``silu(gate) * up`` of ``[gate | up]``."""
        if not self.swiglu:
            return F.silu(h)
        g, u = h.chunk(2, dim=-1)
        return F.silu(g) * u

    def _tp_only(self, what: str) -> None:
        if self.n > 1:
            raise NotImplementedError(
                f"MoE {what} under moe_strategy 'tp' at tp = {self.n} (ag_group_gemm, "
                "moe_reduce_rs, global_presort_index: ROADMAP A7) is not ported; the EP "
                "strategy serves tp > 1")

    # -- parameter construction ------------------------------------------

    def fuse_expert_gate_up(self, gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
        """Per-expert (E, K, F) gate and up as the (E, K, 2F) ``[gate | up]``
        layout: the EP layout at any n (JAX ``fuse_expert_gate_up(ep=True)``)
        and the JAX rank-blocked ``[gate_r | up_r]`` of the TP strategy at
        one rank."""
        return torch.cat([gate, up], dim=-1)

    def shard_params_ep(self, router: torch.Tensor, w_up: torch.Tensor,
                        w_dn: torch.Tensor) -> MoEParams:
        """The EP layout (JAX ``P(axis, None, None)``): the tp = 1 tensors
        as they are, rank r's experts their rows ``[r E/n, (r + 1) E/n)``."""
        return MoEParams(router=router, w_up=w_up, w_dn=w_dn)

    def init(self, generator: torch.Generator, hidden: int, ffn: int, *, ep: bool = False,
             dtype=torch.bfloat16, scale: float = 0.02, device=None) -> MoEParams:
        """N(0, ``scale``) router and expert weights drawn from
        ``generator`` (which must live on ``device``), made there: the
        tp = 1 draw, which is also the EP layout (``ep``)."""
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
        w_dn = normal((e, ffn, hidden))
        if ep:
            return self.shard_params_ep(router, w_up, w_dn)
        self._tp_only("weights")
        return MoEParams(router=router, w_up=w_up, w_dn=w_dn)

    # -- one rank ----------------------------------------------------------

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
        self._tp_only("prefill")
        return self._forward(params, x)

    def forward_replicated(self, params: MoEParams,
                           x: torch.Tensor) -> torch.Tensor:
        """Decode: (B, K) -> (B, K) in x's dtype.  At one rank the psum of
        the partial sums is the identity."""
        self._tp_only("decode")
        return self._forward(params, x)

    # -- EP ------------------------------------------------------------------

    def _route_and_sort_ranks(self, x: torch.Tensor, router: torch.Tensor):
        """Each rank's rows (n, m, K) routed and sorted by expert, all ranks
        at once (JAX ``_route_and_sort`` per rank): one stable sort of the
        n m k routed rows keyed (rank, expert), which leaves rank r's rows,
        sorted, at r m k.  Returns (x_sorted (n, m k, K), splits (n, E)
        int32, weights (n m k,) in (token, choice) order, unsort (n m k,)
        over all ranks' rows)."""
        n, m, kdim = x.shape
        e = self.num_experts
        eid, wts = topk_route(torch.matmul(x, router), self.top_k, renormalize=self.renormalize)
        key = eid + torch.arange(n, dtype=eid.dtype, device=x.device)[:, None, None] * e
        xr, kflat, wflat = flatten_topk(x.reshape(n * m, kdim), key.reshape(n * m, -1),
                                        wts.reshape(n * m, -1))
        x_sorted, splits, unsort = sort_by_expert(xr, kflat, n * e)
        return x_sorted.reshape(n, -1, kdim), splits.reshape(n, e), wflat, unsort

    def _local_experts(self, params: MoEParams, recv: torch.Tensor, recv_splits: torch.Tensor,
                       rows: int, dtype, wire: str | None) -> torch.Tensor:
        """Every rank's zones (n, n, Z, W) through its experts (JAX
        ``forward_ep``'s ``local_experts``): the zone rows compacted
        expert-major (the owned expert of each zone row by ``searchsorted``,
        a stable argsort, the rows past the counts to the tail), the grouped
        products, the rows put back in the zone layout.  The compaction's
        first ``rows`` rows are all the real ones (every routed row is
        real), so only they are gathered and multiplied: JAX multiplies the
        zero tail too and zeroes its result.  With ``wire`` the zones hold
        packed u8 rows, unpacked to ``dtype`` after the gather and packed
        again before the scatter.  Zone rows past the counts stay unwritten:
        the combine never sends them."""
        n, _, z, w = recv.shape
        epr = self.num_experts // n
        cum = torch.cumsum(recv_splits, -1, dtype=torch.int32)            # (n, n, epr)
        j = torch.arange(z, dtype=torch.int32, device=recv.device).expand(n, n, z)
        eid = torch.searchsorted(cum, j.contiguous(), right=True)          # (n, n, z)
        rank = torch.arange(n, device=recv.device)[:, None, None]
        key = torch.where(eid < epr, rank * epr + eid, n * epr)
        real = torch.argsort(key.reshape(-1), stable=True)[:rows]
        compact = recv.reshape(-1, w).index_select(0, real)
        if wire:
            compact = quant.unpack_rows(compact, w - quant.SIDECAR, wire, dtype)
        gsz = recv_splits.sum(1, dtype=torch.int32).reshape(-1)           # (E,), rank-major
        h = self._combine(grouped_matmul(compact, params.w_up, gsz))
        y = grouped_matmul(h, params.w_dn, gsz).to(dtype)
        if wire:
            y = quant.pack_rows(y, wire)
        out = torch.empty((n * n * z, y.shape[-1]), dtype=y.dtype, device=y.device)
        return out.index_copy_(0, real, y).reshape(n, n, z, -1)

    def forward_ep(self, params: MoEParams, x: torch.Tensor, *,
                   a2a_config: AllToAllConfig | None = None) -> torch.Tensor:
        """Prefill under EP: route -> dispatch (K17) -> local experts (K5)
        -> combine (K17) -> weighted top-k fold, each hop's rows packed by
        K18 on the fp8 wire (JAX's ``quantized_ep_dispatch`` and
        ``quantized_ep_combine``: pack, move the u8 rows, unpack; here
        through their wire halves, the dispatch's zones unpacked after the
        compaction and the experts' rows packed before the scatter, row for
        row the same values).
        ``x``: (n, M/n, K) rank-stacked over the mesh's axis; returns the
        same, in x's dtype.  One rank is the one-rank forward, as JAX's
        shortcut gives."""
        if self.n == 1:
            return self._forward(params, x.reshape(-1, x.shape[-1])).reshape(x.shape)
        n, m, hdim = x.shape
        x_sorted, splits, wflat, unsort = self._route_and_sort_ranks(x, params.router)
        cfg = a2a_config or AllToAllConfig()
        wire = "fp8" if self.fp8_wire_enabled() else None
        rows = x_sorted.shape[1]
        if wire:
            recv, recv_splits = dispatch_packed(x_sorted, splits, self.mesh, self.axis, cfg, wire)
        else:
            recv, recv_splits = ep_dispatch(x_sorted, splits, self.mesh, self.axis, config=cfg)
        processed = self._local_experts(params, recv, recv_splits, n * rows, x.dtype, wire)
        if wire:
            back = combine_packed(processed, splits, self.mesh, self.axis, cfg, rows, hdim, wire,
                                  x.dtype)
        else:
            back = ep_combine(processed, splits, self.mesh, self.axis, token_dim=rows, config=cfg)
        # each rank's unsort and weighted fold
        y = unsort_combine(back.reshape(n * rows, hdim), unsort, wflat, self.top_k)
        return y.reshape(n, m, hdim).to(x.dtype)

    def forward_replicated_ep(self, params: MoEParams, x: torch.Tensor) -> torch.Tensor:
        """Decode under EP: (B, K) one copy -> (B, K) in x's dtype (module
        docstring).  One rank is the one-rank forward."""
        if self.n == 1:
            return self._forward(params, x)
        n, k = self.n, self.top_k
        b = x.shape[0]
        eid, wts = topk_route(torch.matmul(x, params.router), k, renormalize=self.renormalize)
        xr, eflat, wflat = flatten_topk(x, eid, wts)
        xs, splits, unsort = sort_by_expert(xr, eflat, self.num_experts)
        h = self._combine(grouped_matmul(xs, params.w_up, splits))
        y = grouped_matmul(h, params.w_dn, splits)
        y = torch.index_select(y, 0, unsort).reshape(b, k, -1)
        yw = y * wflat.reshape(b, k, 1).to(y.dtype)
        owner = torch.div(eid, self.num_experts // n, rounding_mode="floor")          # (B, k)
        mine = owner[None] == torch.arange(n, device=x.device)[:, None, None]       # (n, B, k)
        partials = torch.where(mine[..., None], yw[None], torch.zeros((), dtype=yw.dtype,
                                                                      device=x.device))
        return partials.sum(dim=2).float().sum(dim=0).to(x.dtype)
