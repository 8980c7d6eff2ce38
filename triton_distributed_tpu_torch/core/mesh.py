"""Meshes of co-located ranks and the rank-stacked layout.

Counterpart of ``triton_distributed_tpu/core/mesh.py``.  The JAX package
builds a ``jax.sharding.Mesh`` over devices; here a mesh's ranks are
co-located on one device: every rank has its own buffers in that device's
memory, and peers address each other's buffers through a table of peer
addresses (``core/symm.py``).  The collectives' device code is written
against that table and a rank, so a host that runs one process per card
changes only how the table is filled.

Layout: a tensor on a mesh carries one leading dimension per mesh axis, in
mesh order, then the rank's shard (the rank-stacked layout).  A
``{"dp": 2, "tp": 4}`` mesh holds a tp-sharded (M, R) array as
(2, 4, M / 4, R).  :func:`shard` and :func:`unshard` convert between it
and the JAX package's global layout, where dim 0 is cut into rank-major
shards.

A replicated tensor (JAX ``P()``: a model's embedding, lm_head and norms,
the decode step's activations) keeps **one** copy on a mesh of co-located
ranks, which every rank reads: it is held unstacked, and PyTorch's
broadcasting reads it against rank-stacked operands (an (M, K) activation
times (n, K, C) rank-stacked weights is every rank's (M, C) product).  Four
copies of Qwen3-8B's embedding and lm_head would cost 7.5 GB more at tp = 4.

A mesh holds at most :data:`MAX_RANKS` ranks: the kernels take the peer
table by value, one pointer per rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch

from .platform import resolve_device

TP_AXIS = "tp"
EP_AXIS = "ep"
SP_AXIS = "sp"
DP_AXIS = "dp"
PP_AXIS = "pp"

MAX_RANKS = 8


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes of co-located ranks, outermost first, on one device.

    A rank's slot is its row-major index over the axes; slot ``s`` is entry
    ``s`` of the leading (mesh) dimensions of a rank-stacked tensor."""

    axes: tuple[tuple[str, int], ...]
    device: torch.device

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(name for name, _ in self.axes)

    @property
    def shape(self) -> dict[str, int]:
        return dict(self.axes)

    @property
    def sizes(self) -> tuple[int, ...]:
        return tuple(size for _, size in self.axes)

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_mesh(axis_sizes: Mapping[str, int], device=None) -> Mesh:
    """A mesh of co-located ranks, e.g. ``{"dp": 2, "tp": 4}`` (outermost
    first).  ``device=None`` is the current CUDA device (raises without
    CUDA); ``device="cpu"`` runs the collectives' plain versions."""
    axes = tuple((str(name), int(size)) for name, size in axis_sizes.items())
    if not axes:
        raise ValueError("a mesh needs at least one axis")
    if any(size < 1 for _, size in axes):
        raise ValueError(f"mesh axes {dict(axes)} must be at least 1 each")
    total = math.prod(size for _, size in axes)
    if total > MAX_RANKS:
        raise ValueError(
            f"mesh axes {dict(axes)} make {total} ranks; a mesh of co-located "
            f"ranks holds at most {MAX_RANKS} (the kernels take one peer "
            f"pointer per rank)")
    return Mesh(axes, resolve_device(device))


def _axis_dim(mesh: Mesh, axis: str) -> int:
    if axis not in mesh.shape:
        raise ValueError(f"axis {axis!r} is not on the mesh {mesh.shape}")
    return mesh.axis_names.index(axis)


def shard(mesh: Mesh, x: torch.Tensor, axis: str = TP_AXIS) -> torch.Tensor:
    """The rank-stacked form of a global ``x`` whose dim 0 is cut over
    ``axis`` into rank-major shards and replicated over the other axes:
    ``(n * m, ...)`` becomes ``(*mesh.sizes, m, ...)``."""
    d = _axis_dim(mesh, axis)
    n = mesh.sizes[d]
    if x.shape[0] % n:
        raise ValueError(f"dim 0 {x.shape[0]} is not divisible by {axis}={n}")
    shards = x.reshape(n, x.shape[0] // n, *x.shape[1:])
    view = [1] * len(mesh.axes)
    view[d] = n
    shards = shards.reshape(*view, *shards.shape[1:])
    return shards.expand(*mesh.sizes, *shards.shape[len(view):]).contiguous()


def unshard(mesh: Mesh, y: torch.Tensor, axis: str = TP_AXIS) -> torch.Tensor:
    """The inverse of :func:`shard` along ``axis``: ``(*mesh.sizes, m, ...)``
    becomes ``(*other sizes, n * m, ...)``, the ranks of ``axis`` concatenated
    in rank order along dim 0 of the shard; the other mesh axes stay leading
    (none for a one-axis mesh)."""
    k = len(mesh.axes)
    if tuple(y.shape[:k]) != mesh.sizes:
        raise ValueError(f"leading dims {tuple(y.shape[:k])} are not the mesh's "
                         f"{mesh.sizes}")
    d = _axis_dim(mesh, axis)
    y = y.movedim(d, k - 1)
    return y.reshape(*y.shape[:k - 1], y.shape[k - 1] * y.shape[k], *y.shape[k + 1:])

