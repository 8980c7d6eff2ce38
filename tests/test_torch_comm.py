"""The port's collectives (AllGather K9, ReduceScatter K10, AllReduce K11)
against the JAX package, on the CPU.

The JAX Pallas collectives do not finish in interpret mode within a test's
time here, so two other surfaces of the JAX package hold the port:

- the protocol recorder (``analysis/record.py::record_kernel`` over the
  cases of ``analysis/registry.py``): every rank's ordered copies, credits
  and waits, which the port's schedules (``comm/ring.py`` and the bodies in
  ``comm/``) must reproduce; the CUDA kernels run those schedules on the
  card, and the plain versions walk them here;
- the XLA references (``resilience/fallbacks.py::xla_*``), which compute
  the same functions with ``lax`` collectives on the 12-device CPU mesh.

Inputs come from ``np.random.default_rng(seed)``.  The kernels themselves
are held to the plain versions, bitwise, on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from triton_distributed_tpu.analysis import record, registry
from triton_distributed_tpu.analysis.events import CopyEv, NotifyEv, WaitEv
from triton_distributed_tpu.comm import allgather as jax_ag
from triton_distributed_tpu.comm import allreduce as jax_ar
from triton_distributed_tpu.core.mesh import make_mesh as jax_mesh
from triton_distributed_tpu.lang.primitives import Team as JaxTeam
from triton_distributed_tpu.lang.primitives import ring_src_rank as jax_ring_src_rank
from triton_distributed_tpu.resilience import fallbacks

from triton_distributed_tpu_torch import comm
from triton_distributed_tpu_torch.comm import ring
from triton_distributed_tpu_torch.comm.allgather import (bidir_program, push_program,
                                                         resolve_method as ag_resolve_method)
from triton_distributed_tpu_torch.comm.allgather import ring_program as ag_ring_program
from triton_distributed_tpu_torch.comm.allreduce import (choose_method as ar_choose_method,
                                                         one_shot_program,
                                                         resolve_method as ar_resolve_method,
                                                         two_shot_program)
from triton_distributed_tpu_torch.comm.launch import walk_mesh
from triton_distributed_tpu_torch.comm.reduce_scatter import ring_program as rs_ring_program
from triton_distributed_tpu_torch.core import symm
from triton_distributed_tpu_torch.core.mesh import make_mesh, shard, unshard
from triton_distributed_tpu_torch.lang.primitives import Notify, Put, Team, Wait, ring_src_rank

RANKS = (2, 3, 4, 8)
BF16 = jnp.bfloat16


def _np(x):
    return np.asarray(jax.device_get(x)).astype(np.float32)


def _bf16(a):
    """f32 values rounded to bf16, as both frameworks round them."""
    return _np(jnp.asarray(a, jnp.float32).astype(BF16))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dtype)


# ---------------------------------------------------------------------------
# schedules: the JAX recorder's events vs the port's programs

# (JAX case name, port program, rows of a chunk in the registry's case)
BODIES = {
    "allgather/push_1shot": (push_program, 4),
    "allgather/ring_1d": (ag_ring_program, 4),
    "allgather/ring_bidir": (bidir_program, 4),
    "reduce_scatter/ring": (rs_ring_program, 4),
    "allreduce/one_shot": (one_shot_program, 4),
    "allreduce/two_shot": (two_shot_program, 2),
}
# JAX semaphores -> the port's flags, per body family (send and local-copy
# semaphores have no counterpart: a put is made by the block's own stores)
_FLAGS = {"recv_sems": "recv", "ag_recv_sems": "recv", "rs_recv_sems": "rs_recv",
          "ack_sems": "ack", "<collective_barrier>": "barrier"}
_ARRIVALS = ("recv", "rs_recv")


def _jax_events(case, rank):
    """(puts, notifies, waits) of one rank of a JAX body, each with its step:
    the number of arrival waits before it.  A put is (step, buffer, entry,
    destination rank, destination rows)."""
    _, thunk = case.make(rank)
    rec = record.record_kernel(thunk, n=case.n, rank=rank)
    family = case.name.split("/")[0]
    puts, notes, waits, step = [], [], [], 0
    for ev in rec.events:
        if isinstance(ev, CopyEv):
            d = ev.dst
            if d.buffer == "out":
                (lo, hi), m = d.bounds[0], d.bounds[0][1] - d.bounds[0][0]
                puts.append((step, "out", lo // m, ev.dst_rank, (lo, hi)))
            else:   # recv_buf / slots: (entry, rows, cols)
                buf = "recv" if d.buffer == "recv_buf" else d.buffer
                puts.append((step, buf, d.bounds[0][0], ev.dst_rank, d.bounds[1]))
        elif isinstance(ev, NotifyEv):
            name, idx = ev.sem
            notes.append((step, _FLAGS[name], idx or 0, ev.target, ev.amount))
        elif isinstance(ev, WaitEv):
            name, idx = ev.sem
            if name not in _FLAGS:
                continue          # send and local-copy semaphores
            flag = _FLAGS[name]
            if family == "reduce_scatter" and flag == "recv":
                flag = "rs_recv"  # the RS kernel names its slot arrivals recv_sems
            amount = ev.amount if ev.unit == "count" else 1
            waits.append((step, flag, idx or 0, amount))
            if flag in _ARRIVALS:
                step += 1
    return puts, notes, waits


def _port_events(program, n, rank, m):
    puts, notes, waits, step = [], [], [], 0
    for op in program(Team((("tp", n),), "tp"), rank):
        if isinstance(op, Put):
            rows = ring.chunk(op.index, m) if op.dst == "out" else (0, m)
            puts.append((step, op.dst, op.index, op.dst_rank, rows))
        elif isinstance(op, Notify):
            notes.append((step, op.flag[0], op.flag[1], op.target, 1))   # a credit of one
        elif isinstance(op, Wait):
            waits.append((step, op.flag[0], op.flag[1], op.count))
            if op.flag[0] in _ARRIVALS:
                step += 1
    return puts, notes, waits


@pytest.mark.parametrize("n", RANKS)
def test_schedules_equal_jax_recorder(n):
    """Every rank of the six bodies: the same puts (step, buffer, chunk or
    slot, destination rank, destination rows), the same ACK and barrier
    credits (step, flag, target), and the same waits, as JAX records them."""
    cases = {c.name: c for c in
             registry._ag_cases(n) + registry._rs_cases(n) + registry._ar_cases(n)}
    assert set(cases) == set(BODIES)
    for name, (program, m) in BODIES.items():
        for rank in range(n):
            want = _jax_events(cases[name], rank)
            got = _port_events(program, n, rank, m)
            for what, w, g in zip(("puts", "notifies", "waits"), want, got):
                assert g == w, f"{name} n={n} rank {rank}: {what} differ"
    # the ACK credits are there to compare (RS and two-shot)
    assert any(f == "ack" for _, f, *_ in _port_events(rs_ring_program, n, 0, 4)[1])


def test_team_device_ids_equal_jax():
    """Team.device_id on a {"dp": 2, "tp": 4} mesh: the mesh slot of each
    peer, seen from every slot, as JAX's Team resolves it under the
    recorder; and ring_src_rank at every step."""
    axes = (("dp", 2), ("tp", 4))
    for axis in ("tp", "dp"):
        port, jteam = Team(axes, axis), JaxTeam(axes, axis)
        for slot in range(8):
            with record.recording(axes, record.coords_of(axes, slot)):
                want = [int(jteam.device_id(p)) for p in range(jteam.size)]
                me = int(jteam.rank())
                srcs = [int(jax_ring_src_rank(jteam, s)) for s in range(jteam.size)]
            assert [port.device_id(p, slot) for p in range(port.size)] == want
            assert port.rank(slot) == me
            assert [ring_src_rank(port, me, s) for s in range(port.size)] == srcs
        assert sorted(s for g in port.groups() for s in g) == list(range(8))


def test_walk_refuses_broken_schedules():
    """The plain versions' walk is also a protocol check: a schedule that
    leaves a credit untaken, or waits for one never given, raises."""
    team = Team((("tp", 3),), "tp")
    x, out = torch.ones(3, 3, 2), torch.empty(3, 1, 2)
    mesh = make_mesh({"tp": 3}, device="cpu")

    def no_drain(t, me):
        return rs_ring_program(t, me)[:-2]

    def extra_wait(t, me):
        return rs_ring_program(t, me) + [Wait(("ack", 0), 1)]

    for prog, match in ((no_drain, "non-zero"), (extra_wait, "deadlock")):
        with pytest.raises(RuntimeError, match=match):
            walk_mesh(prog, team, mesh, x, out, 2, {"recv": 2})


# ---------------------------------------------------------------------------
# values: the port's plain versions vs the XLA references


def _meshes(n):
    return jax_mesh({"tp": n}, devices=jax.devices()[:n]), make_mesh({"tp": n}, device="cpu")


@pytest.mark.parametrize("n", (2, 3, 8))
def test_all_gather_equals_xla(n):
    """Every method, every rank's copy, exactly (a gather copies bytes)."""
    rng = np.random.default_rng(n)
    jm, tm = _meshes(n)
    for rows in (1, 3):
        x = rng.standard_normal((n * rows, 136)).astype(np.float32)
        want = _np(fallbacks.xla_all_gather(jnp.asarray(x), jm, "tp"))
        for dtype in (torch.float32, torch.bfloat16):
            xs = shard(tm, _t(x, dtype))
            exp = want if dtype == torch.float32 else _bf16(want)
            for method in list(comm.AllGatherMethod):
                out = comm.all_gather(xs, tm, method=method)
                assert out.shape == (n, n * rows, 136)
                for r in range(n):
                    np.testing.assert_array_equal(out[r].float().numpy(), exp)


@pytest.mark.parametrize("n", (2, 4, 8))
def test_reductions_f32_match_xla(n):
    """RS and both AR methods in f32 within 1e-6 of sum |x|: each sums n
    partials in its own order, n - 1 <= 7 adds of relative error 2**-24 each
    (4.2e-7 of sum |x|), below the limit."""
    rng = np.random.default_rng(10 + n)
    jm, tm = _meshes(n)
    x = rng.standard_normal((n * n * 3, 40)).astype(np.float32)
    xs = shard(tm, _t(x))
    lim = 1e-6 * np.abs(x.reshape(n, -1, 40)).sum(0)
    rs = unshard(tm, comm.reduce_scatter(xs, tm)).numpy()
    want = _np(fallbacks.xla_reduce_scatter(jnp.asarray(x), jm, "tp"))
    assert np.all(np.abs(rs - want) <= lim)
    want = _np(fallbacks.xla_all_reduce(jnp.asarray(x), jm, "tp"))
    for method in (comm.AllReduceMethod.ONE_SHOT, comm.AllReduceMethod.TWO_SHOT):
        out = comm.all_reduce(xs, tm, method=method).numpy()
        for r in range(n):
            assert np.all(np.abs(out[r] - want) <= lim), (method, r)


def _jax_ring_sums(x, n, last_f32, out_dtype):
    """An independent bf16 computation in JAX's ring order, step by step in
    jnp: chunk j starts at rank j + 1 and gains each rank's partial in turn,
    rounded to bf16 at every hop (blocks.add_body); the last hop, at rank j,
    is a bf16 add too, or with ``last_f32`` an f32 add rounded to
    ``out_dtype`` (blocks.sum_body).  Returns the (M, R) result."""
    parts = jnp.asarray(x, jnp.float32).astype(BF16).reshape(n, n, -1, x.shape[-1])
    chunks = []
    for j in range(n):
        acc = parts[(j + 1) % n, j]
        for k in range(2, n):
            acc = acc + parts[(j + k) % n, j]
        mine = parts[j, j]
        last = ((acc.astype(jnp.float32) + mine.astype(jnp.float32)).astype(out_dtype)
                if last_f32 else acc + mine)
        chunks.append(last)
    return _np(jnp.concatenate(chunks))


def _jax_one_shot(x, n, out_dtype):
    parts = jnp.asarray(x, jnp.float32).astype(BF16).reshape(n, -1, x.shape[-1])
    acc = parts[0].astype(jnp.float32)
    for i in range(1, n):
        acc = acc + parts[i].astype(jnp.float32)
    return _np(acc.astype(out_dtype))


@pytest.mark.parametrize("n", (2, 3, 4, 8))
def test_reductions_bf16(n):
    """bf16 exactly equal to the step-by-step jnp computation in JAX's order
    (the same adds, rounded at the same points), and within (n - 1) 2**-8 of
    sum |x| of the XLA reference, which sums and rounds in its own order:
    each of the n - 1 bf16 roundings costs at most 2**-9 of the running
    |sum| <= sum |x|, and the two sides each round."""
    rng = np.random.default_rng(20 + n)
    jm, tm = _meshes(n)
    x = rng.standard_normal((n * n * 2, 24)).astype(np.float32)
    xb = _bf16(x)
    xs = shard(tm, _t(x, torch.bfloat16))
    lim = (n - 1) * 2.0 ** -8 * np.abs(xb.reshape(n, -1, 24)).sum(0)
    rs = unshard(tm, comm.reduce_scatter(xs, tm)).float().numpy()
    np.testing.assert_array_equal(rs, _jax_ring_sums(x, n, False, BF16))
    want = _np(fallbacks.xla_reduce_scatter(jnp.asarray(x).astype(BF16), jm, "tp"))
    assert np.all(np.abs(rs - want) <= lim)
    xla_ar = _np(fallbacks.xla_all_reduce(jnp.asarray(x).astype(BF16), jm, "tp"))
    for out_dtype, t_out in ((BF16, torch.bfloat16), (jnp.float32, torch.float32)):
        one = comm.all_reduce(xs, tm, method=comm.AllReduceMethod.ONE_SHOT, out_dtype=t_out)
        two = comm.all_reduce(xs, tm, method=comm.AllReduceMethod.TWO_SHOT, out_dtype=t_out)
        assert one.dtype == two.dtype == t_out
        exp_one = _jax_one_shot(x, n, out_dtype)
        exp_two = _jax_ring_sums(x, n, True, out_dtype)
        for r in range(n):
            np.testing.assert_array_equal(one[r].float().numpy(), exp_one)
            np.testing.assert_array_equal(two[r].float().numpy(), exp_two)
            assert np.all(np.abs(two[r].float().numpy() - xla_ar) <= lim)
            assert np.all(np.abs(one[r].float().numpy() - xla_ar) <= lim)


def test_dp_tp_mesh_groups():
    """On {"dp": 2, "tp": 4} each dp group gathers and reduces only its own
    tp ranks: with the same data in both groups the result is JAX's on its
    {"dp": 2, "tp": 4} mesh (tests/test_allgather.py:40); with different
    data each group's result is its own."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    rng = np.random.default_rng(3)
    jm = jax_mesh({"dp": 2, "tp": 4})
    tm = make_mesh({"dp": 2, "tp": 4}, device="cpu")
    x = rng.standard_normal((16, 8)).astype(np.float32)
    xj = jax.device_put(jnp.asarray(x), NamedSharding(jm, P("tp")))
    xs = shard(tm, _t(x), "tp")
    assert xs.shape == (2, 4, 4, 8)
    want = _np(fallbacks.xla_all_gather(xj, jm, "tp"))
    for method in list(comm.AllGatherMethod)[1:]:
        out = comm.all_gather(xs, tm, "tp", method=method)
        for d in range(2):
            for r in range(4):
                np.testing.assert_array_equal(out[d, r].numpy(), want)
    want = _np(fallbacks.xla_all_reduce(xj, jm, "tp"))
    out = comm.all_reduce(xs, tm, "tp", method=comm.AllReduceMethod.TWO_SHOT)
    assert np.all(np.abs(out.numpy() - want) <= 1e-6 * 4 * np.abs(x).max())
    # distinct data per group: dp group d sees only x2[d]
    x2 = _t(rng.standard_normal((2, 4, 8, 8)).astype(np.float32))
    g = comm.all_gather(x2, tm, "tp", method=comm.AllGatherMethod.RING_BIDIR)
    rs = comm.reduce_scatter(x2, tm, "tp")
    ar = comm.all_reduce(x2, tm, "tp", method=comm.AllReduceMethod.ONE_SHOT)
    for d in range(2):
        total = x2[d].sum(0)
        for r in range(4):
            assert torch.equal(g[d, r], x2[d].reshape(32, 8))
            torch.testing.assert_close(rs[d, r], total[2 * r:2 * r + 2], atol=1e-5, rtol=0)
            torch.testing.assert_close(ar[d, r], total, atol=1e-5, rtol=0)
    # and a collective over dp: tp rank t's pair (0, t), (1, t)
    out = comm.all_reduce(x2, tm, "dp", method=comm.AllReduceMethod.ONE_SHOT)
    torch.testing.assert_close(out[1, 2], x2[0, 2] + x2[1, 2], atol=1e-6, rtol=0)


def test_single_rank_and_refusals(monkeypatch):
    x = torch.randn(1, 4, 8)
    m1 = make_mesh({"tp": 1}, device="cpu")
    assert comm.all_gather(x, m1) is x
    assert comm.reduce_scatter(x, m1) is x
    assert comm.all_reduce(x, m1, out_dtype=torch.bfloat16).dtype == torch.bfloat16
    m4 = make_mesh({"tp": 4}, device="cpu")
    x4 = torch.randn(4, 4, 8)
    for fn in (comm.all_gather, comm.reduce_scatter, comm.all_reduce):
        with pytest.raises(NotImplementedError, match="B9"):
            fn(x4, m4, wire_dtype="int8")
        with pytest.raises(NotImplementedError, match="tuple axis"):
            fn(x4, m4, ("dp", "tp"))
        with pytest.raises(ValueError, match="rank-stacked"):
            fn(x4[:2], m4)
    with pytest.raises(ValueError, match="not divisible"):
        comm.reduce_scatter(torch.randn(4, 3, 8), m4)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        comm.all_reduce(x4.half(), m4)
    with pytest.raises(ValueError, match="at most 8"):
        make_mesh({"dp": 3, "tp": 3}, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh({"tp": 2})
    assert make_mesh({"tp": 2}, device="cpu").device.type == "cpu"


def test_choose_method_equals_jax():
    """The size rules, over a grid of shard bytes and rank counts, and AUTO
    through resolve_method; pads and landing slots start at zero."""
    sizes = [1, 4 << 10, 256 << 10, (256 << 10) + 2, 512 << 10, (512 << 10) + 2, 64 << 20]
    for n in (1, 2, 3, 4, 8):
        for b in sizes:
            assert comm.choose_method(b, n).value == jax_ag.choose_method(b, n).value
            assert ar_choose_method(b, n).value == jax_ar.choose_method(b, n).value
    assert (ag_resolve_method(comm.AllGatherMethod.AUTO, (4096, 4096), torch.bfloat16, 8)
            == comm.AllGatherMethod.RING_BIDIR)
    assert (ag_resolve_method(comm.AllGatherMethod.AUTO, (1, 4096), torch.bfloat16, 4)
            == comm.AllGatherMethod.PUSH_1SHOT)
    # TWO_SHOT with rows not divisible by n runs ONE_SHOT, as in JAX
    assert (ar_resolve_method(comm.AllReduceMethod.TWO_SHOT, 6, 8192, 4)
            == comm.AllReduceMethod.ONE_SHOT)
    assert (ar_resolve_method(comm.AllReduceMethod.AUTO, 4096, 8192, 4)
            == comm.AllReduceMethod.TWO_SHOT)
    m = make_mesh({"dp": 2, "tp": 4}, device="cpu")
    pad = symm.signal_pad(m, "tp", "allgather")
    assert pad.data.shape == (2, 4, symm.MAX_LANES * 32) and not pad.data.any()
    args = symm.coll_args(Team.of(m, "dp"), m, x=torch.zeros(2, 4, 2), out=torch.zeros(2, 4, 4),
                          land=None, pad=pad, chunk_elems=2, method=0)
    assert (args.n, args.groups, list(args.slot)) == (2, 4, [0, 4, 1, 5, 2, 6, 3, 7])


def test_landing_slots_are_views_of_one_growing_buffer():
    """Landing slots are views of one buffer per (team, family, dtype) that
    grows to the largest call so far: a smaller call reuses it, a larger one
    replaces it, and each rank's slots start at its row of the buffer."""
    m = make_mesh({"dp": 2, "tp": 4}, device="cpu")
    a = symm.landing(m, "tp", "test_landing", (2, 6), torch.float32)
    assert a.data.shape == (2, 4, 2, 6)
    row = a.ptrs()[1] - a.ptrs()[0]
    assert row == 12 * 4 and a.ptrs() == [a.ptrs()[0] + s * row for s in range(8)]
    b = symm.landing(m, "tp", "test_landing", (2, 3), torch.float32)
    assert b.data.shape == (2, 4, 2, 3) and b.ptrs() == a.ptrs()
    c = symm.landing(m, "tp", "test_landing", (4, 6), torch.float32)
    assert c.ptrs()[1] - c.ptrs()[0] == 24 * 4
    c.data[1, 2].fill_(7.0)
    assert symm.landing(m, "tp", "test_landing", (2, 6), torch.float32).data[1, 2].eq(7.0).all()
    h = symm.landing(m, "tp", "test_landing", (2, 6), torch.bfloat16)
    assert h.data.dtype == torch.bfloat16 and h.ptrs()[0] != c.ptrs()[0]
