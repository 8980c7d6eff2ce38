"""K17's, K11's one-shot and K9's lane protocols on the card, walked on the CPU.

``triton_distributed_tpu_torch/comm/lanes.py`` mirrors what
``csrc/all_to_all.cu`` and ``csrc/ring.cuh::one_shot_phase`` do lane by
lane: K17 shares each destination's rows among the lanes, credits once per
(lane, destination), a share of zero rows included, and waits once per
source; K11's one-shot credits and waits once per peer, then sums in slot
order.  Here the walk runs under seeded random interleavings of the lanes at
n = 2 and 4, one to more lanes than rows, uneven splits and a source that
sends nothing, at device scope and with the system-scope form's entry
barrier, and must

- fill every zone's valid rows as ``resilience/fallbacks.py::xla_ep_dispatch``
  and the port's plain version do, bitwise, and give every real row back
  through the combine (``xla_ep_combine``, the round trip);
- give K11's one-shot the slot-order f32 sum of the port's plain version
  (``comm.all_reduce_ref``) and of the same sum written in jnp, bitwise;
- never block a lane forever, and leave every flag at zero.

A dropped credit, a wait on the wrong source, a lane that skips the credit
of a zero-row share and a rank that credits nothing must each fail by name.

K9's device-scope forms (the push, the one-way and the two-way ring, no
entry barrier; ``comm/lanes.py`` ``push_agents``/``ring_agents``) and their
system-scope forms are walked likewise at n = 2, 3, 4 over 1, 3 and 7
lanes, on shards moved in 16-, 4- and 1-byte units: every rank's copy
equals JAX's ``all_gather(..., tiled=True)`` and the port's plain version
bitwise, every flag back at zero; a dropped credit and a stalled rank fail
by name; the lanes' byte shares tile each chunk once.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from triton_distributed_tpu.resilience import fallbacks

import triton_distributed_tpu_torch as tt
from triton_distributed_tpu_torch import comm
from triton_distributed_tpu_torch.comm import all_to_all as A
from triton_distributed_tpu_torch.comm import lanes, tiles
from triton_distributed_tpu_torch.lang.primitives import Team

SEEDS = (0, 1)
MODES = ("uneven", "silent", "one_peer")


class _MeshShape:
    """What ``xla_ep_dispatch``/``xla_ep_combine`` read of a mesh."""

    def __init__(self, n):
        self.shape = {"tp": n}


def _splits(rng, n: int, t: int, e: int, mode: str) -> np.ndarray:
    """(n, E) rows per expert: uneven totals; rank 1 sending nothing; every
    row to rank n - 1."""
    out = np.zeros((n, e), np.int32)
    for r in range(n):
        if mode == "one_peer":
            ids = np.full(t, e - e // n)
        elif mode == "silent" and r == 1:
            ids = np.zeros(0, int)
        else:
            ids = rng.integers(0, e, int(rng.integers(0, t + 1)))
        out[r] = np.bincount(ids, minlength=e)
    return out


def _a2a_case(n: int, t: int, mode: str, dtype):
    """(x, splits, the mesh's meta, z, the XLA zones (n, n, z, H), the XLA
    combine (n, t, H)) for f32 or bf16 rows of H = 8."""
    rng = np.random.default_rng(300 + 10 * n + t)
    h = 8
    spl = _splits(rng, n, t, 2 * n, mode)
    xf = rng.standard_normal((n, t, h)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx = jnp.asarray(xf).astype(jdt)
    x = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(dtype)
    jr, _ = fallbacks.xla_ep_dispatch(jx.reshape(n * t, h), jnp.asarray(spl.reshape(-1)),
                                      _MeshShape(n), "tp")
    jr = jnp.asarray(jr).reshape(n, n, -1, h)
    jc = fallbacks.xla_ep_combine(jr.reshape(n * n, -1, h), jnp.asarray(spl.reshape(-1)),
                                  _MeshShape(n), "tp", token_dim=t)
    mesh = tt.make_mesh({"tp": n}, device="cpu")
    meta = A._meta(torch.from_numpy(spl), Team.of(mesh, "tp"), mesh)
    f32 = lambda a: torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))  # noqa: E731
    return x, spl, mesh, meta, jr.shape[2], f32(jr), f32(jc).reshape(n, t, h)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("lane_count", (1, 3, 9))
@pytest.mark.parametrize("n", (2, 4))
def test_a2a_lanes_match_xla(n, lane_count, mode):
    """K17's dispatch and combine walked lane by lane: every zone's valid
    rows equal ``xla_ep_dispatch``'s and the plain version's, every real row
    comes back through the combine as ``xla_ep_combine`` gives it and as it
    left; f32 and bf16 rows, 5 rows a rank (9 lanes: more lanes than rows),
    device scope and, for one seed, the system-scope form."""
    for dtype in (torch.float32, torch.bfloat16):
        x, spl, mesh, meta, z, want, want_c = _a2a_case(n, 5, mode, dtype)
        send, offs = meta.send.tolist(), meta.offs.tolist()
        plain, _ = comm.ep_dispatch_ref(x, torch.from_numpy(spl), mesh, "tp")
        for seed in SEEDS:
            zones = lanes.walk_a2a(x, send, offs, z, lane_count, seed=seed,
                                   system_scope=seed == 1)
            for r in range(n):
                for s in range(n):
                    cnt = send[s][r]
                    assert torch.equal(zones[r, s, :cnt].float(), want[r, s, :cnt])
                    assert torch.equal(zones[r, s, :cnt], plain[r, s, :cnt])
            # combine: zone s of rank r goes back to s, into back-zone r
            back_counts = [[send[d][s] for d in range(n)] for s in range(n)]
            zone_offs = [[d * z for d in range(n)] for _ in range(n)]
            back = lanes.walk_a2a(zones.reshape(n, n * z, -1), back_counts, zone_offs, z,
                                  lane_count, seed=seed)
            got = back.reshape(-1, x.shape[-1]).index_select(
                0, A._repack_index(meta, mesh, n, z, x.shape[1])).reshape(x.shape)
            for r, total in enumerate(spl.sum(1)):
                assert torch.equal(got[r, :total].float(), want_c[r, :total])
                assert torch.equal(got[r, :total], x[r, :total])


def _jnp_slot_sum(x: torch.Tensor, out_dtype) -> np.ndarray:
    """The slot-order f32 sum written in jnp (JAX ``blocks.sum_body``)."""
    parts = jnp.asarray(x.float().numpy())
    acc = parts[0]
    for i in range(1, x.shape[0]):
        acc = acc + parts[i]
    jdt = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
    return np.asarray(acc.astype(jdt).astype(jnp.float32))


@pytest.mark.parametrize("lane_count", (1, 3, 7))
@pytest.mark.parametrize("n", (2, 3, 4))
def test_one_shot_lanes_give_the_slot_order_sum(n, lane_count):
    """K11's one-shot walked lane by lane equals the plain version and the
    jnp slot-order sum bitwise, bf16 in, bf16 and f32 out, f32 in and out;
    16-element lane cuts (7 lanes over 5 cuts: idle lanes) and 1-element
    ones; both scopes."""
    gen = torch.Generator().manual_seed(40 + n)
    mesh = tt.make_mesh({"tp": n}, device="cpu")
    one = comm.AllReduceMethod.ONE_SHOT
    for in_dt, out_dt in ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
                          (torch.float32, torch.float32)):
        x = torch.randn((n, 3, 24), generator=gen).to(in_dt)
        plain = comm.all_reduce_ref(x, mesh, "tp", one, out_dt)
        want = _jnp_slot_sum(x, out_dt)
        for seed, quantum in zip(SEEDS, (16, 1)):
            got = lanes.walk_one_shot(x, lane_count, out_dt, quantum=quantum, seed=seed,
                                      system_scope=seed == 1)
            assert torch.equal(got, plain)
            for r in range(n):
                np.testing.assert_array_equal(got[r].float().numpy(), want)


FAULTS = {
    "dropped_credit": dict(drop_credit=(2, 1, 0)),
    "wrong_source": dict(wrong_source=(3, 2)),
    "zero_credit_skipped": dict(skip_zero_credit=True),
    "stalled_rank": dict(stall_rank=1),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a2a_faults_are_caught(fault):
    """K17 at n = 4 with 6 lanes over 2 rows a destination (lanes with
    zero-row shares): each planted fault leaves a lane waiting forever, or
    tells it of a share that has not arrived, and the walk names it."""
    n, rows, h = 4, 2, 4
    x = torch.randn((n, n * rows, h), generator=torch.Generator().manual_seed(9))
    counts = [[rows] * n for _ in range(n)]
    offs = [[d * rows for d in range(n)] for _ in range(n)]
    with pytest.raises(tiles.ProtocolError, match="deadlock|before they arrived"):
        lanes.walk_a2a(x, counts, offs, 8, 6, seed=3, **FAULTS[fault])


@pytest.mark.parametrize("fault", ("dropped_credit", "stalled_rank"))
def test_one_shot_faults_are_caught(fault):
    """K11's one-shot with a credit left out or a rank that credits nothing
    deadlocks, and the walk names the lanes and flags."""
    x = torch.randn((4, 2, 16), generator=torch.Generator().manual_seed(11))
    kw = {"dropped_credit": dict(drop_credit=(0, 1, 2)), "stalled_rank": dict(stall_rank=3)}
    with pytest.raises(tiles.ProtocolError, match="deadlock.*recv"):
        lanes.walk_one_shot(x, 2, **kw[fault])


def test_lane_shares_tile_each_count():
    """K17's shares tile any count exactly and in lane order, with more lanes
    than units (hundreds of lanes a rank over a one-row share of 256
    units) and zero units included."""
    for units, count in ((0, 3), (1, 5), (7, 3), (256, 264), (524288, 264)):
        cuts = [lanes.share(units, count, ln) for ln in range(count)]
        assert cuts[0][0] == 0 and cuts[-1][1] == units
        assert all(hi == lo2 for (_, hi), (lo2, _) in zip(cuts, cuts[1:]))
        assert all(hi >= lo for lo, hi in cuts)


# (dtype, shard): 288 bytes (16-byte units), 10 bytes (1-byte units), 36
# bytes (4-byte units) a rank
GATHER_SHARDS = ((torch.float32, (3, 24)), (torch.bfloat16, (1, 5)), (torch.bfloat16, (3, 6)))
GATHER_METHODS = {"push": comm.AllGatherMethod.PUSH_1SHOT, "ring": comm.AllGatherMethod.RING_1D,
                  "bidir": comm.AllGatherMethod.RING_BIDIR}


@pytest.mark.parametrize("form", lanes.GATHER_FORMS)
@pytest.mark.parametrize("lane_count", (1, 3, 7))
@pytest.mark.parametrize("n", (2, 3, 4))
def test_gather_lanes_match_jax_all_gather(n, lane_count, form):
    """K9 walked lane by lane, at device scope and (the second seed) in the
    system-scope form: every rank's copy equals ``jax.lax.all_gather(...,
    tiled=True)`` and the plain version bitwise, f32 and bf16, shards of
    16-, 4- and 1-byte units (7 lanes over 2 units: idle lanes)."""
    rng = np.random.default_rng(500 + 10 * n + lane_count)
    mesh = tt.make_mesh({"tp": n}, device="cpu")
    gather = jax.vmap(lambda v: jax.lax.all_gather(v, "i", tiled=True), axis_name="i")
    for dtype, shard in GATHER_SHARDS:
        jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        jx = jnp.asarray(rng.standard_normal((n, *shard)).astype(np.float32)).astype(jdt)
        want = np.asarray(gather(jx).astype(jnp.float32))
        x = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(dtype)
        plain = comm.all_gather_ref(x, mesh, "tp", GATHER_METHODS[form])
        for seed in SEEDS:
            got = lanes.walk_gather(x, lane_count, form, seed=seed, system_scope=seed == 1)
            assert torch.equal(got, plain)
            np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("fault", ("dropped_credit", "stalled_rank"))
@pytest.mark.parametrize("form", lanes.GATHER_FORMS)
def test_gather_faults_are_caught(form, fault):
    """K9 at n = 4 over 3 lanes with one credit left out (rank 2, lane 1,
    its first) or a rank that credits nothing deadlocks, and the walk names
    the lanes and flags."""
    x = torch.randn((4, 2, 16), generator=torch.Generator().manual_seed(13))
    kw = {"dropped_credit": dict(drop_credit=(2, 1, 0)), "stalled_rank": dict(stall_rank=3)}
    with pytest.raises(tiles.ProtocolError, match="deadlock.*recv"):
        lanes.walk_gather(x, 3, form, seed=5, **kw[fault])


def test_gather_lanes_tile_each_chunk_once():
    """K9's lanes cut every shard into byte shares at its unit that tile it
    exactly once, in lane order: one unit a thread at device scope (two
    lanes at the decode width, 1 x 4096 bf16), the card's lanes for a large
    shard, at least two units a thread at system scope."""
    for nbytes in (1, 10, 36, 288, 8192, 1024 * 4096 * 2, 4104 * 17 * 4):
        unit = lanes.gather_unit(nbytes)
        assert nbytes % unit == 0
        for fit in (1, 3, 165, 264):
            for system_scope in (False, True):
                count = lanes.gather_lanes(nbytes, fit, system_scope)
                assert 1 <= count <= fit
                cuts = [tiles.lane_slice(nbytes, count, ln, unit) for ln in range(count)]
                assert cuts[0][0] == 0 and cuts[-1][1] == nbytes
                assert all(hi == lo2 for (_, hi), (lo2, _) in zip(cuts, cuts[1:]))
                assert all(hi >= lo and lo % unit == 0 for lo, hi in cuts)
    assert lanes.gather_lanes(4096 * 2, 165) == 2
    assert lanes.gather_lanes(1024 * 4096 * 2, 165) == 165
    assert lanes.gather_lanes(4096 * 2, 165, system_scope=True) == 1
