"""ReduceScatter as a ring on a mesh of co-located ranks (K10).

Counterpart of ``triton_distributed_tpu/comm/reduce_scatter.py``.  At step
s each rank adds its own chunk to the partial sum received from the left
and forwards it right, so every chunk visits every rank once.  The partial
travels through two receive slots per rank, which ACK credits protect
(``comm/ring.py::rs_ring_phase``).  Each hop adds in the input dtype, as
JAX's ``blocks.add_body`` does, so chunk j's sum is ((x_{j+1} + x_{j+2}) +
...) + x_j, rounded at every hop.

Port decisions:

- Input rank-stacked ``(*mesh.sizes, M, ...)``, each rank's partial addend;
  rank r's result is rows ``r*M/n:(r+1)*M/n`` of the sum of its team's n
  partials, ``(*mesh.sizes, M / n, ...)``.
- The add is fused into the put (no send buffer): a hop reads the received
  partial and the local chunk and writes the sum into the right
  neighbour's slot, with JAX's order and rounding.
- :class:`ReduceScatterConfig` is accepted and its tile unused on the card:
  the kernel's blocks cut each chunk into lanes instead.
- float32 and bfloat16; a tuple axis and a quantized wire raise
  ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core import symm
from ..core.launches import count
from ..core.mesh import TP_AXIS, Mesh
from ..lang import primitives as dl
from ..lang.primitives import Team
from . import ring
from .launch import check_reduce_dtype, launch, stacked_shard, walk_mesh


@dataclasses.dataclass(frozen=True)
class ReduceScatterConfig:
    bm: int = 256   # JAX's add-pipeline tile; not used by the kernel
    bn: int = 512


def ring_program(team: Team, me: int) -> list:
    """JAX ``_rs_ring_kernel``'s schedule."""
    prog = []
    dl.collective_prologue(prog, team, me, neighbors_only=True)
    ring.rs_ring_phase(prog, team, me, ("out", 0), last_f32=False)
    ring.rs_ack_drain(prog, team.size)
    return prog


def _setup(x: torch.Tensor, mesh: Mesh, axis: str):
    shard = stacked_shard(x, mesh, axis)
    team = Team.of(mesh, axis)
    m_loc = shard[0] // team.size
    out = torch.empty((*mesh.sizes, m_loc, *shard[1:]), dtype=x.dtype, device=x.device)
    return team, x.contiguous(), out, m_loc * math.prod(shard[1:])


def reduce_scatter_ref(x: torch.Tensor, mesh: Mesh, axis: str = TP_AXIS) -> torch.Tensor:
    """Plain version of K10, on any device: the ring's schedule walked on
    tensors, adding in the input dtype at every hop."""
    team, x, out, chunk_elems = _setup(x, mesh, axis)
    if chunk_elems:
        walk_mesh(ring_program, team, mesh, x, out, chunk_elems, {"recv": 2})
    return out


def _reduce_scatter(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """K10 for a CUDA tensor, the plain version for a CPU one."""
    if not x.is_cuda:
        return reduce_scatter_ref(x, mesh, axis)
    team, x, out, chunk_elems = _setup(x, mesh, axis)
    if chunk_elems:
        land = symm.landing(mesh, axis, "reduce_scatter", (2, chunk_elems), x.dtype)
        launch("tdt_reduce_scatter", "reduce_scatter", team, mesh, x, out, land,
               chunk_elems, 0)
        count("reduce_scatter", ("ring", team.size, tuple(x.shape[len(mesh.axes):])))
    return out


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axis: str = TP_AXIS, *,
                   config: ReduceScatterConfig | None = None,
                   wire_dtype: str = "bf16") -> torch.Tensor:
    """Ring ReduceScatter over ``axis``.

    ``x``: rank-stacked ``(*mesh.sizes, M, ...)``, each rank's partial
    addend, M divisible by n.  Returns ``(*mesh.sizes, M / n, ...)``: rank
    r holds rows ``r*M/n:(r+1)*M/n`` of the element-wise sum (golden:
    ``x.reshape(n, M, ...).sum(0)`` scattered).  ``config`` is accepted for
    the JAX signature; ``n == 1`` returns ``x``."""
    del config
    shard = stacked_shard(x, mesh, axis, wire_dtype)
    check_reduce_dtype(x, x.dtype)
    n = mesh.shape[axis]
    if shard[0] % n:
        raise ValueError(f"partial rows {shard[0]} not divisible by {axis}={n}")
    if n == 1:
        return x
    return _reduce_scatter(x, mesh, axis)
