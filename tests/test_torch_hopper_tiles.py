"""The work lists of the Hopper redesigns of K5 and K1, walked on the CPU.

K5's prefill form (``csrc/group_gemm.cu``, 128 x 256 x 64 on ``wgmma``)
walks per-group work units whose mirror is
``ops/swizzle.py::grouped_work_units``.  Held to JAX's
``grouped_tile_schedule`` (the Pallas kernel's schedule), for each case:

- every (row, group) pair below ``sum(splits)`` that JAX's schedule computes
  is stored by exactly one unit of each n-tile, and no unit stores a row of
  another group;
- the rows from ``sum(splits)`` to T are the zero tail, outside every unit;
- units are group-major, and there are sum(ceil(n_g / 128)) x cdiv(N, 256).

Cases: empty groups; groups of 1, 127, 128, 129 and 256 rows; everything in
one group; T not a multiple of 128; ``sum(splits)`` below T.  Then the
wrapper's choice of form, and K1's units (``ops/attention.py::
flash_work_items``): every (batch, q head, q tile) once, heaviest first,
each with the kv tiles causality needs, and each taken by one persistent
block (``flash_block_units``).
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from triton_distributed_tpu.ops.swizzle import grouped_tile_schedule as jax_schedule

from triton_distributed_tpu_torch.core.utils import cdiv
from triton_distributed_tpu_torch.ops import group_gemm as G
from triton_distributed_tpu_torch.ops.attention import flash_block_units, flash_work_items
from triton_distributed_tpu_torch.ops.swizzle import (
    UNIT_FIELDS,
    derived_work_units,
    grouped_work_units,
)

BM, BN = 128, 256
SCHEDULE = jax.jit(jax_schedule, static_argnums=(1, 2))

# (T, N, splits)
UNIT_CASES = [
    (640, 200, [0, 1, 0, 127, 128, 129, 0, 255]),           # empty groups, 1..129 rows
    (512, 1536, [256, 256]),
    (700, 2048, [0, 0, 700, 0]),                             # all in one group
    (1000, 256, [129, 127, 1, 256, 0, 128, 300]),            # T off the tile, a zero tail
    (300, 8, [5, 0, 7, 3, 0, 9, 4, 2]),                      # most of T a zero tail
    (1, 200, [1]),
    (37, 1536, [0, 0, 0]),                                   # no rows at all
    (4096, 1536, list(np.random.default_rng(0).multinomial(4000, np.ones(16) / 16))),
]
IDS = [f"T{t}-N{n}-E{len(s)}" for t, n, s in UNIT_CASES]


def _units(t, n, splits):
    return grouped_work_units(torch.tensor(splits, dtype=torch.int32), t, n)


def _jax_pairs(t, splits) -> set:
    """(row, group) for every row JAX's schedule multiplies, at 8-row tiles
    over T rounded up to them (its rows must divide)."""
    sched = SCHEDULE(jnp.asarray(np.asarray(splits, np.int32)), cdiv(t, 8) * 8, 8)
    pairs = set()
    for valid, g, lo, hi in zip(*(np.asarray(a) for a in (
            sched.valid, sched.group_ids, sched.row_starts, sched.row_ends))):
        if valid:
            pairs |= {(r, int(g)) for r in range(lo, hi)}
    return pairs


@pytest.mark.parametrize("t,n,splits", UNIT_CASES, ids=IDS)
def test_units_store_each_row_once(t, n, splits):
    u = _units(t, n, splits)
    ends = np.cumsum(splits)
    starts = ends - np.asarray(splits)
    stored = {}
    for valid, g, m0, row_end, n0 in zip(*(x.tolist() for x in u[:5])):
        if not valid:
            assert (g, m0, row_end, n0) == (0, 0, 0, 0), "a padding unit is not zeros"
            continue
        assert row_end == ends[g] and starts[g] <= m0 < ends[g], \
            f"unit ({g}, {m0}) lies outside its group"
        assert n0 % BN == 0 and n0 < n
        for r in range(m0, min(m0 + BM, row_end)):
            stored[(r, g, n0)] = stored.get((r, g, n0), 0) + 1
    assert all(c == 1 for c in stored.values()), "a row is stored twice"
    want = _jax_pairs(t, splits)
    for n0 in range(0, n, BN):
        assert {(r, g) for r, g, col in stored if col == n0} == want
    assert u.tail == (int(sum(splits)), t)
    covered = {r for r, _, _ in stored} | set(range(*u.tail))
    assert covered == set(range(t)), "a row is neither in a unit nor in the zero tail"


@pytest.mark.parametrize("t,n,splits", UNIT_CASES, ids=IDS)
def test_units_group_major_and_counted(t, n, splits):
    u = _units(t, n, splits)
    valid = u.valid.numpy().astype(bool)
    assert len(valid) == (cdiv(t, BM) + len(splits)) * cdiv(n, BN)
    real = int(valid.sum())
    assert valid[:real].all() and not valid[real:].any(), "real units are not a prefix"
    assert real == sum(cdiv(s, BM) for s in splits) * cdiv(n, BN)
    g = u.group_ids.numpy()[:real]
    assert (np.diff(g) >= 0).all(), "units are not group-major"
    # within a group: n-tile next, m-tile fastest
    key = np.stack([g, u.n0.numpy()[:real], u.m0.numpy()[:real]], 1)
    assert [tuple(k) for k in key] == sorted(tuple(k) for k in key)
    # the card's derivation is read back in UNIT_FIELDS; on the CPU the mirror
    derived = derived_work_units(torch.tensor(splits, dtype=torch.int32), t, n)
    for f in UNIT_FIELDS:
        assert torch.equal(derived[f], getattr(u, f))


@pytest.mark.parametrize("t,dtype,want", [
    (1, torch.bfloat16, G.DECODE_CONFIG), (1023, torch.bfloat16, G.DECODE_CONFIG),
    (1024, torch.bfloat16, G.PREFILL_CONFIG), (32768, torch.bfloat16, G.PREFILL_CONFIG),
    (32768, torch.float32, G.F32_CONFIG)])
def test_default_form_by_rows(t, dtype, want):
    assert G.default_config(t, dtype) == want
    assert G.kernel_config(t, 128, 1536, dtype) == want
    if dtype == torch.bfloat16 and t >= G.SMALL_T:
        assert (want.bm, want.bn, want.bk) == (128, 256, 64)


def test_config_without_kernel_refused():
    for cfg, dtype in ((G.GroupGemmConfig(64, 128, 32), torch.bfloat16),
                       (G.PREFILL_CONFIG, torch.float32),
                       (G.F32_CONFIG, torch.bfloat16)):
        with pytest.raises(ValueError, match="has no"):
            G.kernel_config(4096, 8, 256, dtype, cfg)


def test_capacity_refused():
    cap = G.KERNEL_CONFIGS[torch.bfloat16][G.PREFILL_CONFIG]
    assert G.kernel_config(10 ** 6, cap, 2048, torch.bfloat16) == G.PREFILL_CONFIG
    with pytest.raises(ValueError, match="exceed"):
        G.kernel_config(4096, cap + 1, 2048, torch.bfloat16)
    with pytest.raises(ValueError, match="exceed"):
        G.kernel_config(16 * 11520, 8, 256, torch.bfloat16, G.DECODE_CONFIG)


@pytest.mark.parametrize("b,h,hk,s,causal", [
    (4, 32, 8, 1024, True), (2, 32, 4, 333, True), (1, 6, 2, 200, False),
    (1, 8, 8, 130, False), (1, 16, 2, 1, True)])
def test_flash_items_cover_each_tile_once(b, h, hk, s, causal):
    items = flash_work_items(b, h, hk, s, s, causal)
    seen = [(bb, hh, qt) for qt, bb, heads, _ in items for hh in heads]
    assert sorted(seen) == [(bb, hh, qt) for bb in range(b) for hh in range(h)
                            for qt in range(cdiv(s, 64))]
    g = h // hk
    for qt, _, heads, n_kt in items:
        assert len({hh // g for hh in heads}) == 1, "a unit's heads share no kv head"
        last = min(qt * 64 + 63, s - 1) if causal else s - 1
        assert (n_kt - 1) * 64 <= last < n_kt * 64, "kv tiles are not what causality needs"
    qts, kv_tiles = [it[0] for it in items], [it[3] for it in items]
    assert qts == sorted(qts, reverse=True), "q tiles are not heaviest first"
    assert kv_tiles == sorted(kv_tiles, reverse=True), "a lighter unit goes first"


@pytest.mark.parametrize("units,blocks", [(1024, 132), (7, 132), (132, 132), (1000, 3)])
def test_flash_blocks_take_each_unit_once(units, blocks):
    shares = flash_block_units(units, blocks)
    assert sorted(u for share in shares for u in share) == list(range(units))
    assert all(share == sorted(share) for share in shares), "a block goes back to a heavier unit"
    # at the 8B shape (1024 units, 132 blocks) the snake keeps every block's
    # causal work within one unit's worth of kv tiles of the mean
    if (units, blocks) == (1024, 132):
        items = flash_work_items(4, 32, 8, 1024, 1024, True)
        work = [sum(items[u][3] for u in share) for share in shares]
        assert max(work) - min(work) <= max(it[3] for it in items)
