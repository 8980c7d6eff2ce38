"""Measured overlap of memory and tensor-core work in the tile pipeline
(counterpart of ``triton_distributed_tpu/tools/overlap.py``).

A kernel's trace shows one opaque span, not its copy and compute phases, so
the overlap is measured by decomposing one tile pipeline into three kernels
over identical walks (K19, ``csrc/overlap_probe.cu``).  In bf16 the
pipeline is the one every served bf16 GEMM runs (``csrc/wgmma_tile.cuh``:
TMA into an mbarrier stage ring, wgmma, one persistent block an SM walking
the output tiles in K6's grouped order, ``ops/matmul.py::tile_walk``):

- **fused**: the real pipelined product A @ B;
- **dma**: the same walk, producer and stage ring, every block landing in
  shared memory and waited on, with the product replaced by a touch of one
  (8, 128) corner per block: the memory stream alone;
- **mxu**: the same walk and tensor-core sequence on blocks (0, 0), loaded
  once: the compute alone.

If the pipeline hides one phase under the other, ``t_fused ~= max(t_dma,
t_mxu)``; if it serializes them, ``t_fused ~= t_dma + t_mxu``;
:func:`hidden_pct` is the share of the smaller phase hidden, clamped to
[0, 1].  Each mode computes JAX's mode's output (the plain versions below
say what); a CUDA tensor launches K19 or raises, and CPU tensors take the
plain versions.
"""

from __future__ import annotations

import functools

import torch

from ..core import build
from ..core.launches import count
from ..core.platform import resolve_device
from ..core.utils import cdiv
from ..ops.attention import KERNEL_DTYPES
from ..ops.matmul import _dense

MODES = ("fused", "dma", "mxu")
# the (bm, bn, bk) tiles K19 is built for, by dtype (csrc/overlap_probe.cu);
# JAX's default (1024, 1024, 512) does not fit in an SM's shared memory
BUILT_TILES = {torch.bfloat16: ((128, 128, 128), (128, 256, 128)),
               torch.float32: ((128, 128, 128),)}
DEFAULT_TILES = {torch.bfloat16: (128, 256, 128), torch.float32: (128, 128, 128)}
CORNER = (8, 128)   # the (rows, columns) of each block the dma probe touches


def fused_ref(a: torch.Tensor, b: torch.Tensor, tile) -> torch.Tensor:
    """The product in f32, rounded once to a's dtype."""
    return (a.float() @ b.float()).to(a.dtype)


def dma_ref(a: torch.Tensor, b: torch.Tensor, tile) -> torch.Tensor:
    """Tile (i, j) filled with the f32 sum of the (8, 128) corners of the
    last k step's blocks, ``sum(A[i bm : +8, (nk-1) bk : +128]) +
    sum(B[(nk-1) bk : +8, j bn : +128])``, cut at the matrix edges."""
    (m, k), n = a.shape, b.shape[1]
    bm, bn, bk = tile
    k0, (r, c) = (cdiv(k, bk) - 1) * bk, CORNER
    sa = torch.stack([a[i:i + r, k0:k0 + c].float().sum() for i in range(0, m, bm)])
    sb = torch.stack([b[k0:k0 + r, j:j + c].float().sum() for j in range(0, n, bn)])
    touch = sa[:, None] + sb[None, :]
    return touch.repeat_interleave(bm, 0).repeat_interleave(bn, 1)[:m, :n].to(a.dtype)


def mxu_ref(a: torch.Tensor, b: torch.Tensor, tile) -> torch.Tensor:
    """Every (bm, bn) tile = the f32 sum over the nk k steps of A's block
    (0, 0) @ B's block (0, 0), cut at the matrix edges."""
    (m, k), n = a.shape, b.shape[1]
    bm, bn, bk = tile
    p = a[:bm, :bk].float() @ b[:bk, :bn].float()
    acc = torch.zeros_like(p)
    for _ in range(cdiv(k, bk)):
        acc = acc + p
    return acc.repeat(cdiv(m, bm), cdiv(n, bn))[:m, :n].to(a.dtype)


_REFS = {"fused": fused_ref, "dma": dma_ref, "mxu": mxu_ref}


def _probe(mode: str, shape, tile, dtype, device, a: torch.Tensor, b: torch.Tensor):
    m, n, k = shape
    if tuple(a.shape) != (m, k) or tuple(b.shape) != (k, n):
        raise ValueError(f"the probe was built for ({m}, {k}) @ ({k}, {n}); got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != dtype or b.dtype != dtype:
        raise ValueError(f"the probe was built for {dtype}; got {a.dtype}, {b.dtype}")
    if a.device != device or b.device != device:
        raise ValueError(f"the probe was built for {device}; got {a.device}, {b.device}")
    if not a.is_cuda:
        return _REFS[mode](a, b, tile)
    a, b = _dense(a), _dense(b)
    out = torch.empty((m, n), dtype=dtype, device=device)
    err = build.library().tdt_overlap_probe(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, *tile, KERNEL_DTYPES[dtype],
        MODES.index(mode), torch.cuda.current_stream(device).cuda_stream)
    build.check(err, f"overlap_probe[{mode}]")
    count("overlap_probe", (mode, m, n, k))
    return out


def overlap_kernels(m: int, n: int, k: int, *, bm: int | None = None, bn: int | None = None,
                    bk: int | None = None, dtype=torch.bfloat16, device=None):
    """(fused, dma, mxu): callables ``(a, b) -> (m, n)`` of one tile
    pipeline (module docstring), on ``device`` (CUDA unless the caller
    passes "cpu", where the plain versions run).  The tile defaults to the
    dtype's largest built tile; a tile K19 was not built for raises
    ValueError naming the built set.  On the card K and N must be multiples
    of 8."""
    dev = resolve_device(device)
    if dtype not in BUILT_TILES:
        raise ValueError(f"dtype {dtype} not served: {list(BUILT_TILES)}")
    dflt = DEFAULT_TILES[dtype]
    tile = (bm or dflt[0], bn or dflt[1], bk or dflt[2])
    if tile not in BUILT_TILES[dtype]:
        raise ValueError(f"K19 has no {dtype} kernel for tile {tile}: built for "
                         f"{list(BUILT_TILES[dtype])}")
    if dev.type == "cuda" and (k % 8 or n % 8):
        raise ValueError(f"K = {k} and N = {n} must be multiples of 8 for K19")
    return tuple(functools.partial(_probe, mode, (m, n, k), tile, dtype, dev)
                 for mode in MODES)


def hidden_pct(t_fused: float, t_dma: float, t_mxu: float) -> float:
    """Share of the smaller phase hidden under the larger, clamped to
    [0, 1] against measurement noise."""
    lo = min(t_dma, t_mxu)
    if lo <= 0:
        return 0.0
    return max(0.0, min(1.0, (t_dma + t_mxu - t_fused) / lo))
