"""The work schedules of the grouped GEMM (counterpart of
``triton_distributed_tpu/ops/swizzle.py::grouped_tile_schedule``).

The rows of a grouped product are sorted by group (expert) and cut into
m-tiles of ``bm`` rows on one grid from row 0.  A tile that several groups
overlap gets one slot per overlapping group; a slot multiplies the tile's
rows that belong to its group by that group's weights.  Slots are numbered
tile-major; the unused tail of the worst-case ``num_tiles + E`` slots is
padding.

K5 (``csrc/group_gemm.cu``) derives the same schedule inside the kernel
from ``splits``, one slot a block, so a grouped product costs one launch
and reads nothing back to the host.  :func:`grouped_tile_schedule` is its
mirror in PyTorch (on the input's device, no host read either), equal to
the JAX schedule array for array where the rows divide into tiles; unlike
the JAX version it also takes a row count that does not, the last tile then
being partial.  :func:`derived_tile_schedule` runs K5's own derivation on
the card and writes it out, so that the two can be held equal.  That is K5's decode form (16-row tiles).

Its prefill form walks per-group work units instead
(:func:`grouped_work_units`): a group's m-tiles start at its first row, so
no unit spans two groups, and units are group-major, the n-tile next and
the m-tile fastest; the rows from ``sum(splits)`` to the end are written as
zeros beside the units.  :func:`derived_work_units` runs the card's own
derivation of that list.

The ring orders (:func:`ring_chunk_order`, :func:`bidir_chunk_order`) are
the order in which the AllGather-GEMM (K12) multiplies the chunks of A: the
local shard first, then each chunk as it arrives.  The ring phases of
``comm/ring.py`` and ``csrc/ring.cuh`` produce them by construction; these
state them, as the JAX module does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import build
from ..core.utils import cdiv


def ring_chunk_order(me: int, n: int, step: int) -> int:
    """The chunk rank ``me`` of ``n`` consumes at step ``step`` of the
    one-way ring (JAX ``ring_chunk_order``): its own, then me - 1, me - 2,
    ... (counter-flow arrival order)."""
    return me if step == 0 else (me + n - step) % n


def bidir_chunk_order(me: int, n: int, step: int) -> int:
    """The chunk consumed at step ``step`` of the two-way ring (JAX
    ``ag_gemm.py:139-144``): me, me - 1, me + 1, me - 2, me + 2, ...; the
    clockwise stream carries ceil((n - 1) / 2) chunks, the other the rest."""
    dist = (step + 1) // 2
    return me if step == 0 else (me - dist if step % 2 else me + dist) % n


class GroupedSchedule(NamedTuple):
    """All int32 of length ``num_slots = cdiv(num_rows, bm) + E``.  Slot
    ``s`` multiplies m-tile ``tile_ids[s]`` by group ``group_ids[s]``'s
    weights for rows ``[row_starts[s], row_ends[s])``.  ``is_first[s]`` is 1
    on the first slot of each tile: K5 has that slot also write the zeros of
    the tile's rows past ``sum(splits)``.  ``valid[s]`` is 0 on padding
    slots, which carry the last real slot's tile and group.  ``covers[s]``
    is 1 when the slot's rows span its whole tile."""

    tile_ids: torch.Tensor
    group_ids: torch.Tensor
    row_starts: torch.Tensor
    row_ends: torch.Tensor
    is_first: torch.Tensor
    valid: torch.Tensor
    covers: torch.Tensor


def grouped_tile_schedule(group_sizes: torch.Tensor, num_rows: int,
                          bm: int) -> GroupedSchedule:
    """The schedule for ``group_sizes`` (E,) rows per group, contiguous from
    row 0 (their sum at most ``num_rows``), in m-tiles of ``bm`` rows."""
    (num_groups,) = group_sizes.shape
    nt = cdiv(num_rows, bm)
    num_slots = nt + num_groups
    dev = group_sizes.device
    i32 = torch.int32

    sizes = group_sizes.to(i32)
    ends = torch.cumsum(sizes, 0, dtype=i32)
    starts = ends - sizes
    tile_lo = torch.arange(nt, dtype=i32, device=dev) * bm

    # groups meeting tile t: from the first one ending past the tile start
    # to the last one starting before the tile end
    first = torch.searchsorted(ends, tile_lo, right=True).to(i32)
    last = (torch.searchsorted(starts, tile_lo + bm) - 1).to(i32)
    per_tile = torch.clamp(last - first + 1, min=0)
    # every tile gets a slot, so a tile past the last group still zero-fills
    slots_per_tile = torch.clamp(per_tile, min=1)
    slot_end = torch.cumsum(slots_per_tile, 0, dtype=i32)
    total = slot_end[nt - 1]

    s = torch.arange(num_slots, dtype=i32, device=dev)
    tile = torch.clamp(torch.searchsorted(slot_end, s, right=True).to(i32),
                       max=nt - 1)
    rank_in_tile = s - (slot_end[tile.long()] - slots_per_tile[tile.long()])
    group = torch.clamp(first[tile.long()] + rank_in_tile, 0, num_groups - 1)

    lo = tile * bm
    row_start = torch.maximum(starts[group.long()], lo)
    row_end = torch.minimum(ends[group.long()], lo + bm)
    valid = s < total
    zero = torch.zeros_like(row_start)
    row_start = torch.where(valid, row_start, zero)
    row_end = torch.where(valid, row_end, zero)
    is_first = ((rank_in_tile == 0) & valid).to(i32)
    last_real = torch.clamp(total - 1, min=0).long()
    tile = torch.where(valid, tile, tile[last_real])
    group = torch.where(valid, group, group[last_real])
    covers = (valid & (row_start == lo) & (row_end == lo + bm)).to(i32)
    return GroupedSchedule(tile, group, row_start, row_end, is_first,
                           valid.to(i32), covers)


SLOT_FIELDS = ("valid", "tile_ids", "group_ids", "row_starts", "row_ends",
               "is_first")


class GroupedUnits(NamedTuple):
    """All int32 of length ``(cdiv(num_rows, bm) + E) * cdiv(num_cols,
    bn)``, a bound of the real count that needs no host read.  Unit ``u``
    with ``valid[u]`` multiplies rows ``[m0[u], min(m0[u] + bm,
    row_ends[u]))`` of group ``group_ids[u]`` by that group's weights into
    columns ``[n0[u], n0[u] + bn)``; rows of the next group that the tile
    also covers are loaded but never stored.  The units past the real ones
    are zeros.  ``tail`` is ``(sum(splits), num_rows)``: the rows written as
    zeros, outside any unit."""

    valid: torch.Tensor
    group_ids: torch.Tensor
    m0: torch.Tensor
    row_ends: torch.Tensor
    n0: torch.Tensor
    tail: tuple


UNIT_FIELDS = ("valid", "group_ids", "m0", "row_ends", "n0")


def grouped_work_units(group_sizes: torch.Tensor, num_rows: int, num_cols: int,
                       bm: int = 128, bn: int = 256) -> GroupedUnits:
    """K5's prefill work list for ``group_sizes`` (E,) rows per group,
    contiguous from row 0, over ``num_cols`` output columns: group g's
    ``ceil(n_g / bm)`` m-tiles times the ``cdiv(num_cols, bn)`` n-tiles,
    group-major, the n-tile next, the m-tile fastest (on the input's
    device; only ``tail`` is read back)."""
    (num_groups,) = group_sizes.shape
    dev = group_sizes.device
    i32 = torch.int32
    nn = cdiv(num_cols, bn)
    count = (cdiv(num_rows, bm) + num_groups) * nn

    sizes = group_sizes.to(i32)
    ends = torch.cumsum(sizes, 0, dtype=i32)
    tiles = (sizes + bm - 1) // bm
    tile_end = torch.cumsum(tiles, 0, dtype=i32)
    tile_start = tile_end - tiles

    u = torch.arange(count, dtype=i32, device=dev)
    # the first group whose tiles end past u // nn: never an empty group
    g = torch.clamp(torch.searchsorted(tile_end, u // nn, right=True),
                    max=num_groups - 1).long()
    local = u - nn * tile_start[g]
    per = torch.clamp(tiles[g], min=1)
    valid = u < tile_end[-1] * nn
    zero = torch.zeros_like(u)
    m0 = torch.where(valid, ends[g] - sizes[g] + (local % per) * bm, zero)
    row_end = torch.where(valid, ends[g], zero)
    n0 = torch.where(valid, (local // per) * bn, zero)
    group = torch.where(valid, g.to(i32), zero)
    return GroupedUnits(valid.to(i32), group, m0, row_end, n0,
                        (int(ends[-1]), num_rows))


def derived_work_units(group_sizes: torch.Tensor, num_rows: int,
                       num_cols: int) -> dict[str, torch.Tensor]:
    """The prefill form's units by :data:`UNIT_FIELDS`: on a CUDA tensor,
    K5's own derivation (``derive_groups`` and ``unit_at`` in
    ``csrc/group_gemm.cu``) in one block, no product; on a CPU tensor,
    :func:`grouped_work_units` with K5's 128 x 256 tile."""
    (num_groups,) = group_sizes.shape
    if group_sizes.device.type == "cpu":
        units = grouped_work_units(group_sizes, num_rows, num_cols)
        return {f: getattr(units, f) for f in UNIT_FIELDS}
    sizes = group_sizes.to(torch.int32).contiguous()
    count = (cdiv(num_rows, 128) + num_groups) * cdiv(num_cols, 256)
    out = torch.empty((len(UNIT_FIELDS), count), dtype=torch.int32, device=sizes.device)
    err = build.library().tdt_grouped_units(
        sizes.data_ptr(), num_rows, num_groups, num_cols, out.data_ptr(),
        torch.cuda.current_stream(sizes.device).cuda_stream)
    build.check(err, "grouped_units")
    return dict(zip(UNIT_FIELDS, out))


def derived_tile_schedule(group_sizes: torch.Tensor, num_rows: int,
                          bm: int) -> dict[str, torch.Tensor]:
    """The slots of :func:`grouped_tile_schedule` that K5 uses, by
    :data:`SLOT_FIELDS`, each field 0 on the padding slots.  On a CUDA
    tensor, K5's own derivation (``derive_slot`` in
    ``csrc/group_gemm.cu``), one block a slot and no product; on a CPU
    tensor, :func:`grouped_tile_schedule`."""
    (num_groups,) = group_sizes.shape
    if group_sizes.device.type == "cpu":
        sched = grouped_tile_schedule(group_sizes, num_rows, bm)
        valid = sched.valid
        return {f: getattr(sched, f) * valid for f in SLOT_FIELDS}
    sizes = group_sizes.to(torch.int32).contiguous()
    out = torch.empty((len(SLOT_FIELDS), num_groups + cdiv(num_rows, bm)),
                      dtype=torch.int32, device=sizes.device)
    err = build.library().tdt_grouped_schedule(
        sizes.data_ptr(), num_rows, num_groups, bm, out.data_ptr(),
        torch.cuda.current_stream(sizes.device).cuda_stream)
    build.check(err, "grouped_schedule")
    return dict(zip(SLOT_FIELDS, out))
