"""Local matmul: the best backend per shape, between the hand-written tiled
GEMM K6 and the library (cuBLAS through ``torch.matmul``).

Counterpart of ``triton_distributed_tpu/ops/matmul.py``.  :func:`matmul`
with explicit ``bm``/``bn``/``bk`` (or a tile ``config``) launches K6
(``csrc/matmul.cu``, replacing the Pallas ``_build_matmul``) with that tile;
``config=LibraryBackend()`` dispatches to ``torch.matmul``; with neither,
the contextual autotuner (``tune/autotuner.py``) resolves the backend per
(m, n, k, dtype, device): a cached winner, else a measurement on the first
call on the card, else the library, which is the default the JAX module
keeps too (``XlaBackend()``): a measured choice, not a fallback.

Port decisions:

- Explicit tiles select one of the tiles K6 is built for
  (:data:`KERNEL_TILES`) or raise :class:`~..tune.autotuner.TileInfeasible`
  (a ``ValueError``).  JAX's ``clip_block`` to a divisor of each dimension
  would name tiles that were never built; K6 predicates its edges instead,
  so M needs no divisor and K and N need only be multiples of 8.
- bf16 tiles run ``wgmma_tile.cuh``'s loop (wgmma + TMA, a 4-stage ring)
  in one persistent block an SM that walks the output tiles in grouped
  order (:func:`tile_walk` mirrors it); f32 runs one block a tile of scalar
  FMA.
- One launch a call, counted under ``"matmul"`` with (m, n, k) as its form
  (``core/launches.py``).  The plain version :func:`matmul_ref` serves CPU
  tensors only; a CUDA tensor launches K6 or raises.
- f32 operands run in full f32 in both backends: K6 by scalar FMA, the
  library under PyTorch's default ``allow_tf32 = False``, which the port
  never changes.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..core import build
from ..core.launches import count
from ..core.utils import cdiv
from ..tune.autotuner import LibraryBackend, TileInfeasible
from .attention import KERNEL_DTYPES, _stream


@dataclasses.dataclass(frozen=True)
class TileSpec:
    """How K6 runs one (bm, bn, bk) tile (``csrc/matmul.cu``).  bf16 tiles:
    ``warpgroups`` consumer warpgroups of 64 rows each on wgmma, beside the
    producer's warpgroup, and a ring of ``stages`` TMA stages of bm x bk of A
    and bk x bn of B, plus 1 KB to align them; the f32 tile: 256 threads of
    scalar FMA on one stage."""

    warpgroups: int
    stages: int
    f32: bool = False

    @property
    def acc_threads(self) -> int:
        """The threads that hold the tile's f32 sums."""
        return 256 if self.f32 else 128 * self.warpgroups

    def smem_bytes(self, bm: int, bn: int, bk: int) -> int:
        if self.f32:
            return (bk * (bm + 4) + bk * bn) * 4
        return self.stages * (bm * bk + bk * bn) * 2 + 1024


# the tiles K6 is built for, by operand dtype (csrc/matmul.cu::tdt_matmul)
KERNEL_TILES = {
    torch.bfloat16: {
        (128, 256, 64): TileSpec(2, 4),
    },
    torch.float32: {(64, 64, 16): TileSpec(0, 1, f32=True)},
}
DEFAULT_TILES = {torch.bfloat16: (128, 256, 64), torch.float32: (64, 64, 16)}
GROUP_M = 8   # m-tiles a group of the walk takes down one n-column (kGroupM)


def grouped_tile(t: int, tiles_m: int, tiles_n: int) -> tuple[int, int]:
    """(m-tile, n-tile) of tile ``t`` in K6's grouped order
    (``csrc/matmul.cu::tile_of``): groups of :data:`GROUP_M` m-tiles, each
    walked down its n-columns, the m-tile fastest."""
    per_group = GROUP_M * tiles_n
    first = t // per_group * GROUP_M
    rows = min(tiles_m - first, GROUP_M)
    return first + t % per_group % rows, t % per_group // rows


def tile_walk(m: int, n: int, tile, blocks: int) -> list[list[tuple[int, int]]]:
    """The (m-tile, n-tile)s each persistent block of K6's bf16 form takes,
    in turn (``matmul_wgmma``; K19's bf16 modes, ``probe_wgmma``, walk their
    tiles the same way): block b takes tiles b, b + blocks, ... of the
    grouped order."""
    bm, bn = tile[0], tile[1]
    tiles_m, tiles_n = cdiv(m, bm), cdiv(n, bn)
    return [[grouped_tile(t, tiles_m, tiles_n) for t in range(b, tiles_m * tiles_n, blocks)]
            for b in range(blocks)]


def _check(a: torch.Tensor, b: torch.Tensor, out_dtype):
    for name, t in (("a", a), ("b", b)):
        if not isinstance(t, torch.Tensor) or t.dim() != 2:
            raise ValueError(f"{name} must be a 2-D torch.Tensor")
    (m, k), (k2, n) = a.shape, b.shape
    if k2 != k:
        raise ValueError(f"inner dims mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"a is on {a.device}, b on {b.device}")
    if a.dtype != b.dtype or a.dtype not in KERNEL_DTYPES:
        raise TypeError(f"operands must share a dtype of bfloat16 or float32, "
                        f"got {a.dtype} and {b.dtype}")
    out_dtype = out_dtype or a.dtype
    if out_dtype not in KERNEL_DTYPES:
        raise TypeError(f"out_dtype {out_dtype} is not bfloat16 or float32")
    return m, n, k, out_dtype


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Plain version of K6: the f32 product of the operands, rounded once."""
    return torch.matmul(a.float(), b.float()).to(out_dtype or a.dtype)


def library_matmul(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """The ``LibraryBackend`` dispatch: one ``torch.matmul`` (cuBLAS on the
    card) in the operands' dtype; bf16 operands with an f32 result take
    ``torch.mm``'s f32 output on the card."""
    out_dtype = out_dtype or a.dtype
    if out_dtype == a.dtype:
        return torch.matmul(a, b)
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=out_dtype)
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def batched_product(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """``a @ b`` over any leading (batch or mesh) dims with f32
    accumulation, rounded once to ``out_dtype`` (a's by default): one
    ``torch.matmul``, or on the card one ``torch.bmm`` with an f32 result for
    bf16 operands.  The plain product the JAX package leaves to XLA
    (``jnp.dot(..., preferred_element_type=...)``)."""
    out_dtype = out_dtype or a.dtype
    if out_dtype == a.dtype:
        return torch.matmul(a, b)
    if a.is_cuda and a.dtype == torch.bfloat16 and a.dim() == b.dim() >= 3:
        lead = a.shape[:-2]
        return torch.bmm(a.flatten(0, -3), b.flatten(0, -3),
                         out_dtype=out_dtype).unflatten(0, lead)
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def _tile(a: torch.Tensor, tile) -> tuple[int, int, int]:
    tile = tuple(int(x) for x in tile)
    if tile not in KERNEL_TILES[a.dtype]:
        raise TileInfeasible(
            f"K6 has no {a.dtype} kernel for tile {tile} (built for "
            f"{list(KERNEL_TILES[a.dtype])})")
    return tile


def _on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the kernel (and may be measured): a CUDA tensor."""
    return t.is_cuda


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` as K6 reads it: row-major and 16-byte aligned (a copy when the
    caller's tensor is strided or offset).  A layout is a property of the
    call, not of the tile, so it is never a reason to refuse a tile."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _kernel(a: torch.Tensor, b: torch.Tensor, tile, out_dtype) -> torch.Tensor:
    """K6 with ``tile`` on the card; the plain version for CPU tensors."""
    (m, k), n = a.shape, b.shape[1]
    bm, bn, bk = _tile(a, tile)
    if k % 8 or n % 8:
        raise TileInfeasible(f"K = {k} and N = {n} must be multiples of 8 for K6")
    if not _on_card(a):
        return matmul_ref(a, b, out_dtype)
    a, b = _dense(a), _dense(b)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    err = build.library().tdt_matmul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, bm, bn, bk,
        KERNEL_DTYPES[a.dtype], KERNEL_DTYPES[out_dtype], _stream(a.device))
    build.check(err, "matmul")
    count("matmul", (m, n, k))
    return out


def _resolve(a, b, m, n, k, out_dtype):
    from ..tune import autotuner as _tune

    return _tune.resolve_config(
        "matmul", _tune.matmul_resolve_key(m, n, k, a.dtype),
        _tune.matmul_candidates_pruned(m, n, k, a.dtype), LibraryBackend(),
        lambda c: (lambda: matmul(a, b, config=c, out_dtype=out_dtype)),
        on_card=_on_card(a))


def matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int | None = None,
           bn: int | None = None, bk: int | None = None, out_dtype=None,
           config=None) -> torch.Tensor:
    """C = A @ B with f32 accumulation, rounded once to ``out_dtype`` (a's
    dtype by default).  ``a`` (M, K), ``b`` (K, N), both bf16 or both f32.

    With no tile and no ``config`` the autotuner resolves the backend per
    shape (a cached winner, a measurement on the first call on the card, or
    the library).  ``config`` takes a resolution: a (bm, bn, bk) tile or
    :class:`~..tune.autotuner.LibraryBackend`.  Explicit ``bm``/``bn``/
    ``bk`` run K6, the unnamed ones from the dtype's default tile."""
    m, n, k, out_dtype = _check(a, b, out_dtype)
    if config is None and bm is None and bn is None and bk is None:
        config = _resolve(a, b, m, n, k, out_dtype)
    if isinstance(config, LibraryBackend):
        return library_matmul(a, b, out_dtype)
    if config is None:
        dbm, dbn, dbk = DEFAULT_TILES[a.dtype]
        config = (bm or dbm, bn or dbn, bk or dbk)
    return _kernel(a, b, config[:3], out_dtype)


def matmul_callable(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None):
    """Resolve the backend for this shape once and return ``(a, b) -> C``
    running it, without the resolution on every call (the form a hot loop
    holds; JAX's returns the jitted executable)."""
    m, n, k, out_dtype = _check(a, b, out_dtype)
    config = _resolve(a, b, m, n, k, out_dtype)
    if isinstance(config, LibraryBackend):
        return functools.partial(library_matmul, out_dtype=out_dtype)
    tile = _tile(a, config[:3])
    return lambda x, y: _kernel(x, y, tile, out_dtype)
