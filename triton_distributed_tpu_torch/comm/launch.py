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
            f"wire_dtype={wire_dtype!r}: the quantized AllGather, ReduceScatter and "
            f"AllReduce (JAX comm/quantized.py, ROADMAP A5) are not ported; only the EP "
            f"all-to-all ships the rows that B9's port (K18) packs; use 'bf16'")
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


# (operand dtype, output dtype) pairs the overlapped GEMMs are built for
GEMM_DTYPES = ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
               (torch.float32, torch.float32))


def gemm_operands(a, b, mesh: Mesh, axis, out_dtype, wire_dtype: str = "bf16"):
    """(a's shard shape, b's shard shape, the output dtype) of an
    overlapped GEMM's rank-stacked operands; raises on what
    :func:`stacked_shard` refuses, operands that are not 2-D shards of one
    dtype, inner dims that differ, and a dtype pair the kernels are not
    built for."""
    a_sh = stacked_shard(a, mesh, axis, wire_dtype)
    b_sh = stacked_shard(b, mesh, axis)
    if len(a_sh) != 2 or len(b_sh) != 2:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must be rank-stacked "
                         f"2-D shards on the mesh {mesh.shape}")
    if a_sh[1] != b_sh[0]:
        raise ValueError(f"inner dims mismatch: shards {a_sh} @ {b_sh}")
    out_dtype = out_dtype or a.dtype
    if a.dtype != b.dtype or (a.dtype, out_dtype) not in GEMM_DTYPES:
        raise TypeError(f"operands {a.dtype}, {b.dtype} -> {out_dtype}: the overlapped GEMMs "
                        f"take {[(str(x)[6:], str(y)[6:]) for x, y in GEMM_DTYPES]}")
    return a_sh, b_sh, out_dtype


def check_config(config) -> None:
    """An overlapped GEMM's ``config``: None only.  Each dtype's kernel is
    built for one tile (K12/K13: ``csrc/wgmma_tile.cuh``'s 128 x 256 in bf16,
    ``csrc/gemm_tile.cuh``'s 64 x 64 in f32; K14's ring: ``gemm_tile.cuh``);
    the tuner's tiles are not wired to these kernels yet."""
    if config is not None:
        raise NotImplementedError(
            f"config={config!r}: the overlapped GEMMs run the one tile each dtype's "
            f"kernel is built for; pass config=None")


def check_tile_dims(k: int, n_cols: int) -> None:
    """The overlapped GEMMs' tiles read 16-byte row pieces (TMA row pitches,
    ``cp.async`` chunks): K and the product's columns must be multiples of
    8."""
    if k % 8 or n_cols % 8:
        raise ValueError(f"K = {k} and N = {n_cols} must be multiples of 8")


def check_reduce_dtype(x: torch.Tensor, out_dtype) -> None:
    for what, dt in (("x", x.dtype), ("out_dtype", out_dtype)):
        if dt not in symm.DTYPE_CODES:
            raise TypeError(f"{what} dtype {dt}: the reductions take float32 or bfloat16")


@functools.lru_cache(maxsize=None)
def _programs(program, team: Team) -> tuple[list, ...]:
    return tuple(program(team, r) for r in range(team.size))


def walk_teams(program, team: Team, bufs_of) -> None:
    """The plain version: every team's programs walked on the buffers
    ``bufs_of(slot)`` gives each mesh slot (``comm/ring.py::walk``)."""
    programs = _programs(program, team)
    for group in team.groups():
        walk(list(programs), [bufs_of(s) for s in group])


def walk_mesh(program, team: Team, mesh: Mesh, x: torch.Tensor, out: torch.Tensor,
              chunk_elems: int, landing: dict[str, int]) -> None:
    """The plain version of a collective: every team's programs walked on
    chunk views of ``x`` and ``out`` (and fresh landing slots,
    ``landing[name]`` entries of ``chunk_elems`` each)."""
    xs, outs = x.reshape(mesh.size, -1), out.reshape(mesh.size, -1)

    def bufs_of(s):
        b = {"x": list(xs[s].split(chunk_elems)), "out": list(outs[s].split(chunk_elems))}
        for name, entries in landing.items():
            b[name] = list(torch.empty(entries, chunk_elems, dtype=x.dtype, device=x.device))
        return b

    walk_teams(program, team, bufs_of)


def launch(entry: str, family: str, team: Team, mesh: Mesh, x: torch.Tensor,
           out: torch.Tensor, land: symm.SymmetricBuffer | None, chunk_elems: int,
           method: int, stall_rank: int = -1, system_scope: bool = False) -> None:
    """Launch C entry point ``entry`` on the current stream over every team
    of the mesh.  Raises on a refused launch; a wait that runs out fails the
    launch on the device."""
    args = symm.coll_args(team, mesh, x=x, out=out, land=land,
                          pad=symm.signal_pad(mesh, team.axis, family),
                          chunk_elems=chunk_elems, method=method, stall_rank=stall_rank,
                          system_scope=system_scope)
    fn = getattr(build.library(), entry)
    build.check(fn(ctypes.byref(args), torch.cuda.current_stream(x.device).cuda_stream), entry)


def launch_gemm(entry: str, family: str, team: Team, mesh: Mesh, *, x: torch.Tensor,
                out: torch.Tensor, land: symm.SymmetricBuffer | None, a: torch.Tensor | None,
                b: torch.Tensor, y: torch.Tensor, chunk_elems: int, m_loc: int, k: int,
                n_cols: int, out_dtype, extra: tuple = (), stall_rank: int = -1) -> None:
    """Launch an overlapped GEMM's C entry point (csrc/overlap_gemm.cu) on
    the current stream over every team of the mesh: ``x``/``out``/``land``
    are the ring's buffers, ``a``/``b`` the operands and ``y`` the GEMM's
    output, all rank-stacked; ``extra`` are the entry's arguments before the
    stream.  Raises on a refused launch."""
    coll = symm.coll_args(team, mesh, x=x, out=out, land=land,
                          pad=symm.signal_pad(mesh, team.axis, family),
                          chunk_elems=chunk_elems, method=0, stall_rank=stall_rank)
    coll.dtype = symm.DTYPE_CODES[b.dtype]
    coll.out_dtype = symm.DTYPE_CODES[out_dtype]
    args = symm.gemm_args(coll, mesh, a=a, b=b, y=y, m_loc=m_loc, k=k, n_cols=n_cols)
    fn = getattr(build.library(), entry)
    build.check(fn(ctypes.byref(args), *extra, torch.cuda.current_stream(b.device).cuda_stream),
                entry)


def loop_product(x: torch.Tensor, w: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """K12's and K13's main loop run alone (``csrc/overlap_gemm.cu``
    ``tdt_wgmma_product``): ``y[r] = x[r] @ w[r]`` for CUDA ``x`` (..., M,
    K) and ``w`` (..., K, N) with the same leading dims, K and N multiples of
    8.  It counts no launch: no path runs it; ``chip_smoke.py`` builds the
    chains that K12 and K13 are held to bitwise on it."""
    return _stacked_product("tdt_wgmma_product", x, w, out_dtype)


def ring_loop_product(x: torch.Tensor, w: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """K14's ring loop run alone (``csrc/overlap_gemm.cu``
    ``tdt_ring_product``: gemm_tile.cuh's tiles as the ring's lanes run
    them), with :func:`loop_product`'s arguments.  It counts no launch: no
    path runs it; ``chip_smoke.py`` builds the chain that K14's ring is held
    to bitwise on it."""
    return _stacked_product("tdt_ring_product", x, w, out_dtype)


def _stacked_product(entry: str, x: torch.Tensor, w: torch.Tensor, out_dtype) -> torch.Tensor:
    out_dtype = out_dtype or x.dtype
    (m, k), n_cols = x.shape[-2:], w.shape[-1]
    lead = x.shape[:-2]
    if w.shape[:-2] != lead or w.shape[-2] != k or not x.is_cuda or x.dtype != w.dtype or (
            x.dtype, out_dtype) not in GEMM_DTYPES:
        raise ValueError(f"{entry} takes CUDA x (..., M, K) and w (..., K, N) of one "
                         f"dtype: got {tuple(x.shape)} {x.dtype}, {tuple(w.shape)} {w.dtype}")
    check_tile_dims(k, n_cols)
    x, w = x.contiguous(), w.contiguous()
    y = torch.empty((*lead, m, n_cols), dtype=out_dtype, device=x.device)
    fn = getattr(build.library(), entry)
    build.check(fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), x.numel() // (m * k), m, k, n_cols,
                   symm.DTYPE_CODES[x.dtype], symm.DTYPE_CODES[out_dtype],
                   torch.cuda.current_stream(x.device).cuda_stream), entry)
    return y
