"""K12's and K13's lane/tile protocol on the card, walked on the CPU.

``triton_distributed_tpu_torch/comm/tiles.py`` mirrors what
``csrc/overlap_gemm.cu`` does lane by lane: which lane takes which tile in
what order, what it waits on and what it credits.  Here it is walked under
seeded random interleavings of the lanes for n = 2, 3, 4 and a few lane
counts, both rings of K12 and K13, and must

- never let a tile read rows or a partial whose flag has not arrived,
- never block a lane forever,
- leave every flag of the pads at zero,
- give the result of ``resilience/fallbacks.py::xla_ag_gemm`` /
  ``xla_gemm_rs`` on the same inputs, within the tolerances that
  ``tests/test_torch_tp.py::test_overlap_ops_match_xla`` states (f32
  within 1e-5; bf16 within the limit of each rounding at the size of the
  value rounded), the gathered A exactly.

A walk whose ready or partial waits are dropped, or whose rank credits
nothing, must fail by name: that is what the checks are for.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from test_torch_tp import _meshes, _np, _operands, _ring_limits, _t
from triton_distributed_tpu.resilience import fallbacks

import triton_distributed_tpu_torch as tt
from triton_distributed_tpu_torch.comm import tiles
from triton_distributed_tpu_torch.layers.tp_mlp import stack_columns, stack_rows

DTYPES = ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16))
TILE = (4, 8)   # small tiles: several a chunk at these sizes
SEEDS = (0, 1, 2)


@functools.lru_cache(maxsize=None)
def _case(n: int, bf16: bool):
    """(a, b, the XLA AllGather-GEMM, the XLA GEMM-RS) at m = 8 n, k = 16 n,
    cols = 8 n, computed once per (n, dtype)."""
    jdt = DTYPES[bf16][0]
    a, b = _operands(np.random.default_rng(60 + n), n, 8 * n, 16 * n, 8 * n)
    if bf16:
        a, b = _np(jnp.asarray(a).astype(jdt)), _np(jnp.asarray(b).astype(jdt))
    jm, _ = _meshes(n)
    ag = _np(fallbacks.xla_ag_gemm(jnp.asarray(a, jdt), jnp.asarray(b, jdt), jm, "tp"))
    rs = _np(fallbacks.xla_gemm_rs(jnp.asarray(a, jdt), jnp.asarray(b, jdt), jm, "tp"))
    return a, b, ag, rs


def _close(got, want, lim, tdt):
    got = got.float().numpy()
    if tdt == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        assert np.all(np.abs(got - want) <= lim), np.abs(got - want).max()


@pytest.mark.parametrize("lanes", (1, 2, 5))
@pytest.mark.parametrize("n", (2, 3, 4))
@pytest.mark.parametrize("bidir", (False, True), ids=("unidir", "bidir"))
def test_ag_gemm_tiles_match_xla(bidir, n, lanes):
    """K12's lanes and tiles, both rings: the walk's C against
    ``xla_ag_gemm`` and its gathered A against A, every seed."""
    _, tm = _meshes(n)
    for bf16, (_, tdt) in enumerate(DTYPES):
        a, b, want, _ = _case(n, bool(bf16))
        k = a.shape[1]
        lim = 2 * k * 2.0 ** -24 * (np.abs(a) @ np.abs(b)) + 2.0 ** -7 * (1 + 2.0 ** -5) * np.abs(
            a @ b)
        a_t, b_t = tt.shard(tm, _t(a, tdt)), stack_columns(_t(b, tdt), n)
        for seed in SEEDS:
            c, gathered = tiles.walk_ag_gemm(a_t, b_t, lanes, TILE, bidir=bidir, seed=seed)
            for r in range(n):
                np.testing.assert_array_equal(gathered[r].float().numpy(), a)
                sl = slice(r * b.shape[1] // n, (r + 1) * b.shape[1] // n)
                _close(c[r], want[:, sl], lim[:, sl], tdt)


@pytest.mark.parametrize("lanes", (1, 2, 5))
@pytest.mark.parametrize("n", (2, 3, 4))
def test_gemm_rs_tiles_match_xla(n, lanes):
    """K13's lanes and tiles: the walk's output against ``xla_gemm_rs``
    within the ring's limit, every seed."""
    _, tm = _meshes(n)
    for bf16, (_, tdt) in enumerate(DTYPES):
        a, b, _, want = _case(n, bool(bf16))
        lim, _ = _ring_limits(a, b, n)
        a_t, b_t = stack_columns(_t(a, tdt), n), stack_rows(_t(b, tdt), n)
        for seed in SEEDS:
            out = tt.unshard(tm, tiles.walk_gemm_rs(a_t, b_t, lanes, TILE, seed=seed))
            _close(out, want, lim, tdt)


@pytest.mark.parametrize("kernel", ("ag_unidir", "ag_bidir", "gemm_rs"))
def test_card_tiles_and_lane_slices(kernel):
    """At the card's own tile shapes (``TILES``: one tile a chunk here) and
    at more lanes than tiles, the walk still matches the rank-level plain
    version bitwise in f32 (the same products, the same adds in the same
    order), and the lanes' slices tile each chunk exactly."""
    from triton_distributed_tpu_torch.ops import ag_gemm as AG
    from triton_distributed_tpu_torch.ops import gemm_rs as RS

    n, lanes = 3, 7
    _, tm = _meshes(n)
    tile = tiles.TILES[torch.float32]
    gen = torch.Generator().manual_seed(5)
    for elems in (1, 15, 16, 17, 24 * 48):
        cuts = [tiles.lane_slice(elems, lanes, ln) for ln in range(lanes)]
        assert cuts[0][0] == 0 and cuts[-1][1] == elems
        assert all(hi == lo2 for (_, hi), (lo2, _) in zip(cuts, cuts[1:]))
    if kernel == "gemm_rs":
        a, b = torch.randn(n, n * 70, 24, generator=gen), torch.randn(n, 24, 72, generator=gen)
        got = tiles.walk_gemm_rs(a, b, lanes, tile, seed=3)
        assert torch.equal(got, RS.gemm_rs_ref(a, b, tm))
    else:
        bidir = kernel == "ag_bidir"
        a, b = torch.randn(n, 70, 24, generator=gen), torch.randn(n, 24, 72, generator=gen)
        c, g = tiles.walk_ag_gemm(a, b, lanes, tile, bidir=bidir, seed=3)
        c_ref, g_ref = AG.ag_gemm_ref(a, b, tm, bidir=bidir)
        assert torch.equal(g, g_ref) and torch.equal(c, c_ref)


@pytest.mark.parametrize("fault", ("skip_ready", "skip_tile_wait", "stall_ag", "stall_rs"))
def test_protocol_faults_are_caught(fault):
    """A walk without K12's ready waits reads rows before they arrive;
    without K13's tile waits it adds a partial before it arrives; a rank
    that credits nothing leaves its neighbour waiting forever.  Each fails
    by name."""
    n, lanes = 3, 2
    gen = torch.Generator().manual_seed(7)
    a, b = torch.randn(n, 8, 16, generator=gen), torch.randn(n, 16, 16, generator=gen)
    a_rs = torch.randn(n, 8 * n, 16, generator=gen)
    run = {"skip_ready": lambda: tiles.walk_ag_gemm(a, b, lanes, TILE, bidir=True,
                                                    skip_ready=True),
           "skip_tile_wait": lambda: tiles.walk_gemm_rs(a_rs, b, lanes, TILE,
                                                        skip_tile_wait=True),
           "stall_ag": lambda: tiles.walk_ag_gemm(a, b, lanes, TILE, bidir=False, stall_rank=1),
           "stall_rs": lambda: tiles.walk_gemm_rs(a_rs, b, lanes, TILE, stall_rank=1)}[fault]
    what = {"skip_ready": "before they arrived", "skip_tile_wait": "before it arrived",
            "stall_ag": "deadlock", "stall_rs": "deadlock"}[fault]
    with pytest.raises(tiles.ProtocolError, match=what):
        run()


def test_tile_flags_fit_the_pads():
    """K13's (hop, tile) flags: the served shapes fit the pads' second half
    with room; a chunk too large for them is refused before any launch."""
    for n, m_loc, cols in ((4, 1024, 4096), (4, 8192, 4096), (8, 4096, 8192)):
        tiles.check_tile_flags(n, m_loc, cols, torch.bfloat16)
    tiles.check_tile_flags(4, 128, 4096, torch.float32)
    with pytest.raises(ValueError, match="tile flags"):
        tiles.check_tile_flags(8, 1 << 16, 8192, torch.float32)
