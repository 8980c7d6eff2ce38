"""AllGather-GEMM on a mesh of co-located ranks (K12).

Counterpart of ``triton_distributed_tpu/ops/ag_gemm.py``: ``C[:, cols_r] =
AllGather_M(A) @ B[:, cols_r]``, the column-parallel half of a TP layer.
Every rank's shard of A travels the ring of the AllGather (K9's one-way or
two-way ring, ``comm/ring.py``) into a gathered copy on every rank, and each
chunk is forwarded the moment it arrives and then multiplied, the local
chunk first, so the copy of chunk s + 1 rides under the product of chunk s
(JAX ``ag_gemm.py:97-117``, the two-way ring ``:139-144``).  On the card one
cooperative launch of K12 (``csrc/overlap_gemm.cu``) runs every rank: its
lanes' spare warps move the ring's slices while the wgmma main loop takes
the rank's tiles chunk by chunk, each chunk as soon as every slice of it is
here (``comm/tiles.py`` mirrors the lanes and tiles); CPU tensors walk the
rank-level schedule with PyTorch ops (:func:`ag_gemm_ref`).

Port decisions:

- Operands are rank-stacked (``core/mesh.py``): ``a`` is ``(*mesh.sizes,
  m_loc, K)``, each rank's rows of A; ``b`` is ``(*mesh.sizes, K, n_loc)``,
  each rank's columns of B.  The result ``c`` is ``(*mesh.sizes, n * m_loc,
  n_loc)``, the gathered A ``(*mesh.sizes, n * m_loc, K)``.
- ``bidir=None`` means the two-way ring for n >= 3, as in JAX (``:355``).
- ``config`` must be None: K12 runs the one tile its dtype's kernel is
  built with; the tuner's wiring of tiles comes later.
- ``wire_dtype`` other than "bf16" (the quantized wire, ROADMAP A5) and a tuple axis
  raise ``NotImplementedError``; n == 1 is a plain product.
- bf16 -> bf16, bf16 -> f32 and f32 -> f32; K and n_loc multiples of 8.
- No backward: the JAX VJP (GEMM-RS for dA, a gather for dB) comes with the
  training path.
"""

from __future__ import annotations

import torch

from ..comm import ring
from ..comm.launch import (check_config, check_tile_dims, gemm_operands, launch_gemm,
                           walk_teams)
from ..core.launches import count
from ..core.mesh import TP_AXIS, Mesh
from ..lang import primitives as dl
from ..lang.primitives import Matmul, Team
from .matmul import batched_product

# ---------------------------------------------------------------------------
# the two bodies' schedules (JAX _ag_gemm_kernel, _ag_gemm_bidir_kernel):
# one's own shard into gathered chunk me, the neighbours' barrier, the ring
# with each chunk's product after its forward


def _program(phase, team: Team, me: int) -> list:
    prog = []
    dl.put(prog, "ag", me, me, [("a", 0)])
    dl.collective_prologue(prog, team, me, neighbors_only=True)
    phase(prog, team, me, "ag", lambda r: prog.append(Matmul(("c", r), ("ag", r))))
    return prog


def unidir_program(team: Team, me: int) -> list:
    return _program(ring.ag_ring_phase, team, me)


def bidir_program(team: Team, me: int) -> list:
    return _program(ring.bidir_ring_phase, team, me)


PROGRAMS = {False: unidir_program, True: bidir_program}


def _setup(a: torch.Tensor, b: torch.Tensor, mesh: Mesh, axis: str, out_dtype):
    team = Team.of(mesh, axis)
    n, (m_loc, k), n_loc = team.size, a.shape[-2:], b.shape[-1]
    gathered = torch.empty((*mesh.sizes, n * m_loc, k), dtype=a.dtype, device=a.device)
    c = torch.empty((*mesh.sizes, n * m_loc, n_loc), dtype=out_dtype, device=a.device)
    return team, a.contiguous(), b.contiguous(), gathered, c


def ag_gemm_ref(a: torch.Tensor, b: torch.Tensor, mesh: Mesh, axis: str = TP_AXIS, *,
                out_dtype=None, bidir: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K12, on any device: the ring's schedule walked on
    tensors, each chunk's product the f32 product of the operands rounded
    once.  Returns (C, the gathered A)."""
    team, a, b, gathered, c = _setup(a, b, mesh, axis, out_dtype or a.dtype)
    m_loc, k = a.shape[-2:]
    if m_loc:
        av, bv = a.reshape(mesh.size, m_loc, k), b.reshape(mesh.size, k, -1)
        gv = gathered.reshape(mesh.size, -1, k)
        cv = c.reshape(mesh.size, -1, c.shape[-1])
        walk_teams(PROGRAMS[bidir], team,
                   lambda s: {"a": [av[s]], "b": [bv[s]], "ag": list(gv[s].split(m_loc)),
                              "c": list(cv[s].split(m_loc))})
    return c, gathered


def _ag_gemm(a: torch.Tensor, b: torch.Tensor, mesh: Mesh, axis: str, out_dtype,
             bidir: bool, stall_rank: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """K12 for CUDA tensors, the plain version for CPU ones.  A
    ``stall_rank`` of 0 or more (tests of the bounded waits only) makes that
    team rank skip the arrival credit of every put."""
    if not a.is_cuda:
        return ag_gemm_ref(a, b, mesh, axis, out_dtype=out_dtype, bidir=bidir)
    team, a, b, gathered, c = _setup(a, b, mesh, axis, out_dtype)
    m_loc, k = a.shape[-2:]
    n_loc = b.shape[-1]
    if m_loc:
        launch_gemm("tdt_ag_gemm", "ag_gemm", team, mesh, x=a, out=gathered, land=None,
                    a=None, b=b, y=c, chunk_elems=m_loc * k, m_loc=m_loc, k=k, n_cols=n_loc,
                    out_dtype=out_dtype, extra=(int(bidir),), stall_rank=stall_rank)
        count("ag_gemm", ("bidir" if bidir else "unidir", team.size, (m_loc, k), (k, n_loc)))
    return c, gathered


def ag_gemm(a: torch.Tensor, b: torch.Tensor, mesh: Mesh, axis: str = TP_AXIS, *,
            config=None, out_dtype=None,
            return_gathered: bool = False, bidir: bool | None = None,
            wire_dtype: str = "bf16"):
    """Overlapped ``AllGather(a) @ b`` over ``axis``.

    ``a``: rank-stacked ``(*mesh.sizes, m_loc, K)``, the rows of A each rank
    holds (JAX: (M, K) sharded on dim 0).  ``b``: ``(*mesh.sizes, K,
    n_loc)``, each rank's columns (JAX: (K, N) sharded on dim 1).  Returns C
    ``(*mesh.sizes, n * m_loc, n_loc)`` in ``out_dtype`` (a's by default),
    rank r's columns of the whole product; with ``return_gathered`` also the
    gathered A ``(*mesh.sizes, n * m_loc, K)``."""
    (m_loc, k), (_, n_loc), out_dtype = gemm_operands(a, b, mesh, axis, out_dtype, wire_dtype)
    check_config(config)
    n = mesh.shape[axis]
    if n == 1:
        c = batched_product(a, b, out_dtype)
        return (c, a) if return_gathered else c
    check_tile_dims(k, n_loc)
    c, gathered = _ag_gemm(a, b, mesh, axis, out_dtype, n >= 3 if bidir is None else bool(bidir))
    return (c, gathered) if return_gathered else c
