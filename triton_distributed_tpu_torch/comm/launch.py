"""What the three collective families share: the rank-stacked input's
checks, the plain version (the schedule walked on tensors, team by team)
and the kernel launch (one cooperative launch for every team of the mesh).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core import build, symm
from ..core.mesh import Mesh
from ..lang.primitives import Team
from .ring import walk


def stacked_shard(x, mesh: Mesh, axis, wire_dtype: str = "bf16") -> tuple[int, ...]:
    """The shard shape of a rank-stacked ``x`` on ``mesh``; raises on a
    quantized wire, a tuple (hierarchical) axis, a foreign axis, leading
    dims that are not the mesh's, or a device other than the mesh's kind."""
    if wire_dtype != "bf16":
        raise NotImplementedError(
            f"wire_dtype={wire_dtype!r}: the quantized wire needs the pack "
            f"kernel B9 (lang/quant.py:145), not ported yet; use 'bf16'")
    if isinstance(axis, (tuple, list)):
        raise NotImplementedError(
            "a tuple axis (the hierarchical collectives) needs more than one "
            "card; the co-located mesh runs one axis at a time")
    if axis not in mesh.shape:
        raise ValueError(f"axis {axis!r} is not on the mesh {mesh.shape}")
    if not isinstance(x, torch.Tensor):
        raise TypeError("x must be a torch.Tensor")
    k = len(mesh.axes)
    if tuple(x.shape[:k]) != mesh.sizes or x.dim() < k + 1:
        raise ValueError(f"x {tuple(x.shape)} is not rank-stacked on the mesh "
                         f"{mesh.shape}: its leading dims must be {mesh.sizes}, "
                         f"then the shard")
    if x.device != mesh.device:
        raise ValueError(f"x is on {x.device}, the mesh on {mesh.device}")
    return tuple(x.shape[k:])


def check_reduce_dtype(x: torch.Tensor, out_dtype) -> None:
    for what, dt in (("x", x.dtype), ("out_dtype", out_dtype)):
        if dt not in symm.DTYPE_CODES:
            raise TypeError(f"{what} dtype {dt}: the reductions take float32 or bfloat16")


@functools.lru_cache(maxsize=None)
def _programs(program, team: Team) -> tuple[list, ...]:
    return tuple(program(team, r) for r in range(team.size))


def walk_mesh(program, team: Team, mesh: Mesh, x: torch.Tensor, out: torch.Tensor,
              chunk_elems: int, landing: dict[str, int]) -> None:
    """The plain version: every team's programs walked on chunk views of
    ``x`` and ``out`` (and fresh landing slots, ``landing[name]`` entries
    of ``chunk_elems`` each)."""
    xs, outs = x.reshape(mesh.size, -1), out.reshape(mesh.size, -1)
    programs = _programs(program, team)
    for group in team.groups():
        bufs = []
        for s in group:
            b = {"x": list(xs[s].split(chunk_elems)), "out": list(outs[s].split(chunk_elems))}
            for name, entries in landing.items():
                b[name] = list(torch.empty(entries, chunk_elems, dtype=x.dtype, device=x.device))
            bufs.append(b)
        walk(list(programs), bufs)


def launch(entry: str, family: str, team: Team, mesh: Mesh, x: torch.Tensor,
           out: torch.Tensor, land: symm.SymmetricBuffer | None, chunk_elems: int,
           method: int, stall_rank: int = -1) -> None:
    """Launch C entry point ``entry`` on the current stream over every team
    of the mesh.  Raises on a refused launch; a wait that runs out fails the
    launch on the device."""
    args = symm.coll_args(team, mesh, x=x, out=out, land=land,
                          pad=symm.signal_pad(mesh, team.axis, family),
                          chunk_elems=chunk_elems, method=method, stall_rank=stall_rank)
    fn = getattr(build.library(), entry)
    build.check(fn(ctypes.byref(args), torch.cuda.current_stream(x.device).cuda_stream), entry)
