"""GEMM-ReduceScatter on a mesh of co-located ranks (K13).

Counterpart of ``triton_distributed_tpu/ops/gemm_rs.py``:
``ReduceScatter_M(A[:, K_r] @ B[K_r, :])``, the row-parallel half of a TP
layer.  Each rank's partial product travels the ReduceScatter ring of K10
(``comm/ring.py::rs_ring_phase``) chunk by chunk: the chunk that travels
farthest (rank me - 1's) is computed first and sent raw; at every later
step the next chunk is computed while the last hop is in flight, then the
received partial and the fresh product are added and sent on, and the last
add lands in this rank's output (JAX ``gemm_rs.py:89-123``).  On the card
one cooperative launch of K13 (``csrc/overlap_gemm.cu``) runs every rank,
tile by tile: a tile's epilogue adds the left neighbour's partial of that
tile as soon as its flag arrives and writes the sum straight into the
right neighbour's landing slot (``comm/tiles.py`` mirrors the lanes and
tiles); CPU tensors walk the rank-level schedule (:func:`gemm_rs_ref`).

Rounding, as JAX's: a chunk's product is rounded to the output dtype (its
``mm_buf``), and every hop adds in the output dtype (``blocks.add_body``:
the f32 sum of the two, rounded once), in ring order.

Port decisions:

- Operands rank-stacked: ``a`` ``(*mesh.sizes, M, k_loc)`` (JAX: (M, K)
  sharded on dim 1), ``b`` ``(*mesh.sizes, k_loc, N)`` (JAX: sharded on dim
  0).  The result is ``(*mesh.sizes, M / n, N)``: rank r's rows of the sum.
- On the card no chunk's product is stored: each tile's epilogue rounds
  it and adds it on the way.  The partials land in n - 1 slots, one a hop
  (JAX keeps two and acknowledges each reuse), so a slot is written once a
  call and needs no acknowledgement; the plain walk keeps JAX's two slots,
  its ACK credits and their drain (``comm/ring.py::rs_ack_drain``).  The
  send semaphores have no counterpart (``lang/primitives.py``).
- ``config`` None only (``ops/ag_gemm.py``); ``wire_dtype``
  other than "bf16" and a tuple axis raise; n == 1 is a plain product.
"""

from __future__ import annotations

import torch

from ..comm import ring, tiles
from ..comm.launch import check_config, check_tile_dims, gemm_operands, launch_gemm, walk_teams
from ..core import symm
from ..core.launches import count
from ..core.mesh import TP_AXIS, Mesh
from ..lang import primitives as dl
from ..lang.primitives import Matmul, Team
from .matmul import batched_product


def make_chunk(prog: list):
    """The ``produce`` step of the GEMM-RS ring: chunk j's rows of A times
    B into product entry j."""
    return lambda j: prog.append(Matmul(("mm", j), ("a", j)))


def ring_program(team: Team, me: int) -> list:
    """JAX ``_gemm_rs_kernel``'s schedule."""
    prog = []
    dl.collective_prologue(prog, team, me, neighbors_only=True)
    ring.rs_ring_phase(prog, team, me, ("out", 0), last_f32=False, local="mm",
                       produce=make_chunk(prog))
    ring.rs_ack_drain(prog, team.size)
    return prog


def rs_buffers(a, b, out, mesh: Mesh, n: int, out_dtype):
    """``bufs_of`` of the plain walk shared by GEMM-RS and GEMM-AR: A's row
    chunks, B, fresh product entries and receive slots, the output's row
    chunks."""
    m, k = a.shape[-2:]
    m_loc, cols = m // n, b.shape[-1]
    av, bv = a.reshape(mesh.size, m, k), b.reshape(mesh.size, k, cols)
    ov = out.reshape(mesh.size, -1, cols)

    def bufs_of(s):
        return {"a": list(av[s].split(m_loc)), "b": [bv[s]], "out": list(ov[s].split(m_loc)),
                "mm": list(torch.empty(n, m_loc, cols, dtype=out_dtype, device=a.device)),
                "recv": list(torch.empty(2, m_loc, cols, dtype=out_dtype, device=a.device))}

    return bufs_of


def launch_rs(entry: str, family: str, team: Team, mesh: Mesh, a, b, out, out_dtype) -> None:
    """Launch K14's ring form: the two receive slots and the product entries
    are landing buffers of the family (``core/symm.py::landing``)."""
    n, (m, k), cols = team.size, a.shape[-2:], b.shape[-1]
    chunk_elems = m // n * cols
    land = symm.landing(mesh, team.axis, family, (2, chunk_elems), out_dtype)
    mm = symm.landing(mesh, team.axis, f"{family}_mm", (n, chunk_elems), out_dtype).data
    launch_gemm(entry, family, team, mesh, x=mm, out=out, land=land, a=a, b=b, y=mm,
                chunk_elems=chunk_elems, m_loc=m // n, k=k, n_cols=cols, out_dtype=out_dtype)


def _setup(a, b, mesh: Mesh, axis: str, out_dtype):
    team = Team.of(mesh, axis)
    m_loc = a.shape[-2] // team.size
    out = torch.empty((*mesh.sizes, m_loc, b.shape[-1]), dtype=out_dtype, device=a.device)
    return team, a.contiguous(), b.contiguous(), out


def gemm_rs_ref(a: torch.Tensor, b: torch.Tensor, mesh: Mesh, axis: str = TP_AXIS, *,
                out_dtype=None) -> torch.Tensor:
    """Plain version of K13, on any device: the ring's schedule walked on
    tensors (products rounded to ``out_dtype``, hops added in it)."""
    out_dtype = out_dtype or a.dtype
    team, a, b, out = _setup(a, b, mesh, axis, out_dtype)
    if out.shape[-2]:
        walk_teams(ring_program, team, rs_buffers(a, b, out, mesh, team.size, out_dtype))
    return out


def _gemm_rs(a: torch.Tensor, b: torch.Tensor, mesh: Mesh, axis: str, out_dtype) -> torch.Tensor:
    """K13 for CUDA tensors, the plain version for CPU ones."""
    if not a.is_cuda:
        return gemm_rs_ref(a, b, mesh, axis, out_dtype=out_dtype)
    team, a, b, out = _setup(a, b, mesh, axis, out_dtype)
    if out.shape[-2]:
        n, (m, k), cols = team.size, a.shape[-2:], b.shape[-1]
        tiles.check_tile_flags(n, m // n, cols, a.dtype)
        land = symm.landing(mesh, team.axis, "gemm_rs", (n - 1, m // n * cols), out_dtype)
        launch_gemm("tdt_gemm_rs", "gemm_rs", team, mesh, x=out, out=out, land=land, a=a, b=b,
                    y=out, chunk_elems=m // n * cols, m_loc=m // n, k=k, n_cols=cols,
                    out_dtype=out_dtype)
        count("gemm_rs", ("ring", team.size, tuple(a.shape[-2:]), tuple(b.shape[-2:])))
    return out


def gemm_rs(a: torch.Tensor, b: torch.Tensor, mesh: Mesh, axis: str = TP_AXIS, *,
            config=None, out_dtype=None,
            wire_dtype: str = "bf16") -> torch.Tensor:
    """Overlapped ``ReduceScatter(a @ b)`` over ``axis``.

    ``a``: rank-stacked ``(*mesh.sizes, M, k_loc)``, each rank's columns of
    the activations; ``b``: ``(*mesh.sizes, k_loc, N)``, each rank's rows of
    the weight.  Returns ``(*mesh.sizes, M / n, N)`` in ``out_dtype`` (a's
    by default): rank r holds rows ``r M / n : (r + 1) M / n`` of the sum of
    the n partial products."""
    (m, k_loc), (_, cols), out_dtype = gemm_operands(a, b, mesh, axis, out_dtype, wire_dtype)
    check_config(config)
    n = mesh.shape[axis]
    if n == 1:
        return batched_product(a, b, out_dtype)
    if m % n:
        raise ValueError(f"M = {m} not divisible by {axis}={n}")
    check_tile_dims(k_loc, cols)
    return _gemm_rs(a, b, mesh, axis, out_dtype)
