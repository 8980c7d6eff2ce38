"""The work lists of K6's and K8's Hopper forms, walked on the CPU.

K6's bf16 form (``csrc/matmul.cu::matmul_wgmma``) is one persistent block an
SM walking the output tiles in grouped order; ``ops/matmul.py::tile_walk``
mirrors it.  For ragged M and N and more or fewer blocks than tiles, every
output tile is taken exactly once, block b taking tiles b, b + blocks, ...
of an order written out here independently (groups of 8 m-tiles, each
walked down its n-columns).  (That the built tiles fit a block and that
the tuner prunes a ring too deep is ``test_torch_matmul.py``'s.)

K8's fold on K1's wgmma body (``csrc/flash_attention.cu``, ``fa::item``)
numbers its units heaviest q tile first whatever ``q_offset - kv_offset``
is (``ops/attention.py::flash_work_items`` with ``delta``), and copies the
state of a unit with no kv tile through.  That predicate is held to the
plain fold ``flash_attention_chunk_ref`` (itself held to JAX state by state
in ``test_torch_attention_state.py``): the rows of a copied unit keep their
state bitwise, and a unit that is not copied has a row that sees a key.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from triton_distributed_tpu_torch.core.utils import cdiv
from triton_distributed_tpu_torch.ops import attention as A
from triton_distributed_tpu_torch.ops import matmul as mm

BF16 = torch.bfloat16


def _grouped_order(tiles_m: int, tiles_n: int) -> list[tuple[int, int]]:
    return [(tm, tn) for g in range(cdiv(tiles_m, 8)) for tn in range(tiles_n)
            for tm in range(8 * g, min(8 * g + 8, tiles_m))]


@pytest.mark.parametrize("tile", list(mm.KERNEL_TILES[BF16]))
@pytest.mark.parametrize("m,n,blocks", [
    (1, 136, 132), (37, 4104, 132), (1000, 7168, 132), (4101, 6144, 132),
    (7168, 7168, 7), (20, 256, 1), (1024, 256, 132), (129, 2048, 132),
    (2049, 1032, 16), (4096, 151936, 132), (8 * 128 + 1, 520, 3), (640, 768, 1000),
    (1, 8, 132)])
def test_k6_walk_takes_each_tile_once_in_grouped_order(tile, m, n, blocks):
    tiles_m, tiles_n = cdiv(m, tile[0]), cdiv(n, tile[1])
    walk = mm.tile_walk(m, n, tile, blocks)
    order = _grouped_order(tiles_m, tiles_n)
    assert len(walk) == blocks
    assert sorted(t for share in walk for t in share) == sorted(
        (tm, tn) for tm in range(tiles_m) for tn in range(tiles_n))
    for b, share in enumerate(walk):
        assert share == order[b::blocks]


SHAPES = [(1, 32, 8, 1024, 1024), (1, 32, 4, 200, 130), (2, 6, 2, 130, 64), (1, 3, 3, 64, 1)]
DELTAS = [-100000, -1088, -64, -63, -1, 0, 37, 1000, 3072, 100000]


@pytest.mark.parametrize("b,h,hk,sq,sc", SHAPES)
def test_k8_units_heaviest_first_for_every_offset(b, h, hk, sq, sc):
    plain = [it[:3] for it in A.flash_work_items(b, h, hk, sq, sc, True)]
    for delta in DELTAS:
        items = A.flash_work_items(b, h, hk, sq, sc, True, delta)
        assert [it[:3] for it in items] == plain, "the order depends on the offsets"
        kv_tiles = [it[3] for it in items]
        assert kv_tiles == sorted(kv_tiles, reverse=True), "a lighter unit goes first"
        for qt, _, _, n_kt in items:
            # the kv tiles the tile's last row inside Sq sees: key j visible
            # when j <= i + delta
            last = min(64 * qt + 63, sq - 1)
            want = sum(1 for j in range(cdiv(sc, 64)) if 64 * j <= last + delta)
            assert n_kt == want
    # without causality every unit reads every kv tile, at any offset
    assert {it[3] for it in A.flash_work_items(b, h, hk, sq, sc, False, -10 ** 6)} == {cdiv(sc, 64)}


def _state(rng, b, h, sq, d):
    m = rng.standard_normal((b, h, sq)).astype(np.float32)
    l = rng.uniform(0.5, 3.0, (b, h, sq)).astype(np.float32)
    acc = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    m[:, :, ::5] = -1e30          # a fresh row here and there
    l[:, :, ::5] = 0.0
    acc[:, :, ::5] = 0.0
    return tuple(torch.from_numpy(x) for x in (m, l, acc))


@pytest.mark.parametrize("q_off,kv_off", [
    (0, 200), (100, 230), (100, 229), (100, 163), (0, 0), (37, 0), (500, 0), (64, 130)])
def test_k8_copy_through_agrees_with_plain_fold(q_off, kv_off):
    """Units that the kernel copies through (no kv tile) keep every row's
    state bitwise in the plain fold; a unit that reads kv tiles has its last
    row inside Sq see a key, which moves that row's l; a chunk wholly in the
    future is copied through everywhere."""
    rng = np.random.default_rng(q_off * 1000 + kv_off)
    b, h, hk, sq, sc, d = 1, 4, 2, 130, 70, 8
    q = torch.from_numpy(rng.standard_normal((b, h, sq, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, hk, sc, d)).astype(np.float32))
            for _ in range(2))
    state = _state(rng, b, h, sq, d)
    got = A.flash_attention_chunk_ref(q, k, v, state, q_off, kv_off, sm_scale=0.35)
    copied = 0
    for qt, bb, heads, n_kt in A.flash_work_items(b, h, hk, sq, sc, True, q_off - kv_off):
        rows = slice(64 * qt, min(64 * qt + 64, sq))
        for hh in heads:
            same = all(torch.equal(x[bb, hh, rows], y[bb, hh, rows]) for x, y in zip(got, state))
            if n_kt == 0:
                copied += 1
                assert same, f"unit (q tile {qt}, head {hh}) is copied but its state moves"
            else:
                last = min(64 * qt + 63, sq - 1)
                assert got[1][bb, hh, last] != state[1][bb, hh, last], \
                    f"unit (q tile {qt}, head {hh}) reads kv tiles its rows do not see"
    future = q_off + sq - 1 < kv_off
    assert (copied == h * cdiv(sq, 64)) == future
    if future:   # a chunk wholly in the future: the state, bitwise
        assert all(torch.equal(x, y) for x, y in zip(got, state))
