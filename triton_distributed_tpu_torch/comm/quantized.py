"""The quantized EP all-to-all: int8 or e4m3 rows on the wire (counterpart
of the forward of ``triton_distributed_tpu/comm/quantized.py``'s
``quantized_ep_dispatch`` and ``quantized_ep_combine``, ``:457-500``).

Each hop packs its rows at the producer (``lang/quant.py::pack_rows``: K18
on the card), moves the (H + 128)-byte u8 message through the all-to-all
(K17) and unpacks it at the consumer, dequantized to the input's dtype (plain
PyTorch ops, as JAX unpacks in jnp).  No full-precision row crosses.

The two wire halves are :func:`dispatch_packed` (pack, then move) and
:func:`combine_packed` (move, then unpack); the JAX entries compose them
with the unpack of every zone row and the pack of every zone row.  The EP
layer (``layers/moe.py``) calls the halves itself: it unpacks only the zone
rows its experts read and packs only the rows they write.

Forward only: JAX's straight-through backward comes with training.  The
quantized AllGather, ReduceScatter and AllReduce (``:86-455``) wait for
ROADMAP A5.
"""

from __future__ import annotations

import torch

from ..core.mesh import Mesh
from ..lang import quant
from .all_to_all import AllToAllConfig, _combine, _dispatch


def dispatch_packed(x: torch.Tensor, splits: torch.Tensor, mesh: Mesh, axis: str,
                    cfg: AllToAllConfig | None, wire_dtype: str):
    """The dispatch hop's wire: every row of ``x`` packed, the u8 rows
    dispatched.  Returns ``(u8 zones, recv_splits)``; zone tails hold
    whatever the landing buffer held there."""
    return _dispatch(quant.pack_rows(x, wire_dtype), splits, mesh, axis, cfg or AllToAllConfig())


def combine_packed(y_u8: torch.Tensor, splits: torch.Tensor, mesh: Mesh, axis: str,
                   cfg: AllToAllConfig | None, token_dim: int, h: int, wire_dtype: str,
                   dtype) -> torch.Tensor:
    """The combine hop's wire: the packed zone rows ``y_u8`` combined, each
    rank's rows unpacked into ``dtype``."""
    back_u8 = _combine(y_u8, splits, mesh, axis, token_dim, cfg or AllToAllConfig())
    return quant.unpack_rows(back_u8, h, wire_dtype, dtype)


def quantized_ep_dispatch(mesh: Mesh, axis: str, cfg: AllToAllConfig | None, h: int,
                          wire_dtype: str, x: torch.Tensor, splits: torch.Tensor):
    """``ep_dispatch`` with a quantized wire: pack, dispatch the u8 rows,
    unpack the zones into ``x.dtype``.  Returns ``(recv, recv_splits)``."""
    recv_u8, recv_splits = dispatch_packed(x, splits, mesh, axis, cfg, wire_dtype)
    return quant.unpack_rows(recv_u8, h, wire_dtype, x.dtype), recv_splits


def quantized_ep_combine(mesh: Mesh, axis: str, cfg: AllToAllConfig | None, h: int,
                         wire_dtype: str, token_dim: int, y: torch.Tensor,
                         splits: torch.Tensor) -> torch.Tensor:
    """``ep_combine`` with a quantized wire: pack the zones, return the u8
    rows, unpack into ``y.dtype``."""
    return combine_packed(quant.pack_rows(y, wire_dtype), splits, mesh, axis, cfg, token_dim, h,
                          wire_dtype, y.dtype)
