"""AllGather along dim 0 on a mesh of co-located ranks (K9).

Counterpart of ``triton_distributed_tpu/comm/allgather.py``.  Three
schedules, as in JAX: a one-shot full-mesh push, a one-way ring and a
two-way ring (``comm/ring.py``).  Every chunk lands at its final offset of
the receiving rank's output behind its own arrival flag, the property the
overlapped AG-GEMM will consume chunk by chunk.  On the card one launch of
K9 (``csrc/collectives.cu``) runs every rank of every team; CPU tensors
walk the same schedule on tensors (``comm/ring.py::walk``).

On the card K9 runs at device scope without JAX's entry barrier (every
rank is a block of the one launch, and the previous call finished on the
same stream), one 16-byte unit a thread on as many lanes as that asks for,
up to what the card holds at once: the push puts its shard into every
rank's output in one pass, then credits and waits once per peer; the rings'
first put reads ``x`` straight into the own and the neighbours' outputs.
``comm/lanes.py`` walks that protocol lane by lane.  The system-scope form
with the barriers (``_all_gather(..., system_scope=True)``) is kept for the
multi-card host.  The results are the same bytes.

Port decisions:

- Input and output are rank-stacked (``core/mesh.py``): ``x`` is
  ``(*mesh.sizes, m, ...)``, the result ``(*mesh.sizes, n * m, ...)``, every
  rank's gathered copy, so a check sees each rank's copy.
- ``method=AUTO`` resolves through :func:`choose_method` alone.  JAX lets
  its tuner measure the methods; on co-located ranks that would measure
  device memory and crown the wrong method for NVLink, so the tuner comes
  with the host that runs one process per card.
- ``wire_dtype`` other than "bf16" (the quantized wire, ROADMAP A5) and a
  tuple axis (the hierarchical gather) raise ``NotImplementedError``.
- No backward: the JAX adjoint is the identity in global semantics and
  comes with the multi-card host.
"""

from __future__ import annotations

import enum
import math

import torch

from ..core.launches import count
from ..core.mesh import TP_AXIS, Mesh
from ..lang import primitives as dl
from ..lang.primitives import Team
from . import ring
from .launch import launch, stacked_shard, walk_mesh


class AllGatherMethod(enum.Enum):
    AUTO = "auto"
    PUSH_1SHOT = "push_1shot"   # full-mesh push: lowest latency, small shards
    RING_1D = "ring_1d"         # one-way ring
    RING_BIDIR = "ring_bidir"   # two-way ring


def choose_method(nbytes_per_shard: int, num_ranks: int) -> AllGatherMethod:
    """JAX's size rule: the push for two ranks or shards up to
    ``push_bytes_threshold()``, else the two-way ring."""
    from ..tools import calibrate

    if num_ranks <= 2 or nbytes_per_shard <= calibrate.push_bytes_threshold():
        return AllGatherMethod.PUSH_1SHOT
    return AllGatherMethod.RING_BIDIR


def resolve_method(method: AllGatherMethod, shard_shape: tuple[int, ...], dtype,
                   num_ranks: int) -> AllGatherMethod:
    """AUTO to a concrete method from the shard's bytes; others pass."""
    if method != AllGatherMethod.AUTO:
        return method
    return choose_method(math.prod(shard_shape) * dtype.itemsize, num_ranks)


# ---------------------------------------------------------------------------
# the three bodies' schedules (JAX _ag_push_kernel, _ag_ring_kernel,
# _ag_ring_bidir_kernel); each starts with its own shard into out-chunk me


def _own_chunk(prog: list, me: int) -> None:
    dl.put(prog, "out", me, me, [("x", 0)])


def push_program(team: Team, me: int) -> list:
    prog = []
    ring.push_phase(prog, team, me, "out")
    return prog


def ring_program(team: Team, me: int) -> list:
    prog = []
    _own_chunk(prog, me)
    dl.collective_prologue(prog, team, me, neighbors_only=True)
    ring.ag_ring_phase(prog, team, me)
    return prog


def bidir_program(team: Team, me: int) -> list:
    prog = []
    _own_chunk(prog, me)
    dl.collective_prologue(prog, team, me, neighbors_only=True)
    ring.bidir_ring_phase(prog, team, me)
    return prog


PROGRAMS = {AllGatherMethod.PUSH_1SHOT: push_program,
            AllGatherMethod.RING_1D: ring_program,
            AllGatherMethod.RING_BIDIR: bidir_program}
# the C entry point's method codes (csrc/collectives.cu)
_CODES = {AllGatherMethod.PUSH_1SHOT: 0, AllGatherMethod.RING_1D: 1,
          AllGatherMethod.RING_BIDIR: 2}


def _setup(x: torch.Tensor, mesh: Mesh, axis: str, out: torch.Tensor | None = None):
    """(team, x contiguous, the output, a shard's elements); ``out`` (the
    AllGather layer's workspace slot) must be the contiguous output of the
    gather's shape, dtype and device, else a fresh tensor is made."""
    shard = stacked_shard(x, mesh, axis)
    team = Team.of(mesh, axis)
    shape = (*mesh.sizes, team.size * shard[0], *shard[1:])
    if out is None:
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
    elif (tuple(out.shape) != shape or out.dtype != x.dtype or out.device != x.device
          or not out.is_contiguous()):
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} on {out.device} is not the "
                         f"contiguous {shape} {x.dtype} on {x.device} the gather writes")
    return team, x.contiguous(), out, math.prod(shard)


def all_gather_ref(x: torch.Tensor, mesh: Mesh, axis: str = TP_AXIS,
                   method: AllGatherMethod = AllGatherMethod.RING_BIDIR, *,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K9, on any device: ``method``'s schedule walked on
    tensors, step by step (``comm/ring.py::walk``), into ``out`` when given."""
    team, x, out, chunk_elems = _setup(x, mesh, axis, out)
    if chunk_elems:
        walk_mesh(PROGRAMS[method], team, mesh, x, out, chunk_elems, {})
    return out


def _all_gather(x: torch.Tensor, mesh: Mesh, axis: str, method: AllGatherMethod,
                stall_rank: int, out: torch.Tensor | None = None, *,
                system_scope: bool = False) -> torch.Tensor:
    """The gather with a concrete method, into ``out`` when given: K9 for a
    CUDA tensor, the plain version for a CPU one.  A ``stall_rank`` of 0 or
    more (tests of the bounded waits only; the public entry passes -1) makes
    that team rank skip the arrival credit of every put, so its peers' waits
    run out.  ``system_scope``: K9's system-scope form (the entry barriers,
    system-scope flags), kept for the multi-card host (ROADMAP A11)."""
    if not x.is_cuda:
        return all_gather_ref(x, mesh, axis, method, out=out)
    team, x, out, chunk_elems = _setup(x, mesh, axis, out)
    if chunk_elems:
        launch("tdt_all_gather", "allgather", team, mesh, x, out, None, chunk_elems,
               _CODES[method], stall_rank, system_scope)
        count("all_gather", (method.value, team.size, tuple(x.shape[len(mesh.axes):])))
    return out


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str = TP_AXIS, *,
               method: AllGatherMethod = AllGatherMethod.AUTO,
               wire_dtype: str = "bf16") -> torch.Tensor:
    """Gather dim 0 of every rank's shard over ``axis`` on every rank.

    ``x``: rank-stacked ``(*mesh.sizes, m, ...)``; returns
    ``(*mesh.sizes, n * m, ...)``, each rank holding the shards of its team
    in rank order (golden: ``jax.lax.all_gather(..., tiled=True)``).  Any
    dtype: the gather copies bytes.  ``n == 1`` returns ``x`` itself."""
    shard = stacked_shard(x, mesh, axis, wire_dtype)
    n = mesh.shape[axis]
    if n == 1:
        return x
    return _all_gather(x, mesh, axis, resolve_method(method, shard, x.dtype, n), -1)
