"""The port's fused decode at tp > 1 and its persistent decode (the fused
GEMM + AllReduce ring K15, the persistent kernel K16) against the JAX
package, on the CPU.

As in ``tests/test_torch_tp.py``, two JAX surfaces that run here hold the
port:

- the protocol recorder (``analysis/record.py::record_kernel`` over
  ``analysis/registry.py``'s ``_fused_mlp_ar_cases`` and
  ``_persistent_cases``): every rank's copies, credits, waits and chunk
  products, in order, which the port's schedules (``ops/fused_decode.py::
  ar_program``, ``ops/persistent_decode.py::persistent_program``) must
  reproduce;
- the XLA references (``resilience/fallbacks.py::xla_fused_mlp_ar``,
  ``xla_gemm_ar``, ``xla_persistent_decode``), which compute the same
  functions without Pallas.  The model test puts them in place of the
  Pallas ops inside the JAX ``Qwen3`` (the names ``models/qwen.py``
  imports), and the attention megakernel in place of a jnp golden built
  from JAX's own pieces (the qkv product, ``rms_norm``, ``apply_rope_at``,
  the page append and ``_xla_decode_fn``, as ``reference_decode_step``
  composes them): four ranks of a Pallas kernel in interpret mode inside
  ``shard_map`` deadlock in the interpreter's teardown here.

Inputs come from ``np.random.default_rng(seed)`` or the JAX model's seeded
weights.  The kernels are held to these plain versions on the card by
``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import triton_distributed_tpu.layers.tp_mlp as jax_tp_mlp
import triton_distributed_tpu.models.qwen as jax_qwen
import triton_distributed_tpu.ops.persistent_decode as jax_pd
from triton_distributed_tpu.analysis import record, registry
from triton_distributed_tpu.analysis.events import ComputeEv, CopyEv, NotifyEv, WaitEv
from triton_distributed_tpu.core.mesh import make_mesh as jax_mesh
from triton_distributed_tpu.layers.norm import rms_norm as jax_rms_norm
from triton_distributed_tpu.models import ModelConfig as JaxConfig
from triton_distributed_tpu.models import Qwen3 as JaxQwen3
from triton_distributed_tpu.models.kv_cache import init_cache as jax_init_cache
from triton_distributed_tpu.models.kv_cache import init_paged_cache as jax_init_paged_cache
from triton_distributed_tpu.ops.rope import apply_rope_at as jax_rope_at
from triton_distributed_tpu.resilience import fallbacks

import triton_distributed_tpu_torch as tt
from triton_distributed_tpu_torch.comm.allreduce import AllReduceMethod, one_shot_program
from triton_distributed_tpu_torch.comm.ring import walk
from triton_distributed_tpu_torch.lang.primitives import (Matmul, Notify, Put, Reduce, Swiglu,
                                                          Team, Wait)
from triton_distributed_tpu_torch.layers.tp_mlp import stack_columns, stack_rows
from triton_distributed_tpu_torch.ops import fused_decode as FD
from triton_distributed_tpu_torch.ops import persistent_decode as PD

N = 4
JCFG = JaxConfig(
    num_layers=2, hidden=64, intermediate=128, num_heads=8, num_kv_heads=4,
    head_dim=16, vocab=256, max_length=64, rope_theta=1e6, rms_eps=1e-6,
    dtype=jnp.float32,
)
TCFG = tt.ModelConfig(**{
    f.name: getattr(JCFG, f.name) for f in dataclasses.fields(JCFG)
    if f.name != "dtype"}, dtype=torch.float32)
BATCH, PROMPT, STEPS, PAGE = 4, 12, 4, 8
TOL = dict(atol=1e-4, rtol=1e-4)
MODES = ("fused", "persistent")
LAYOUTS = ("contiguous", "paged")


def _np(x):
    return np.asarray(jax.device_get(x)).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dtype)


# ---------------------------------------------------------------------------
# schedules: the JAX recorder's events vs the port's programs

_SEMS = {"recv_sems": "rs_recv", "ack_sems": "ack", "ag_recv_sems": "recv",
         "<collective_barrier>": "barrier"}
_ARRIVALS = ("recv", "rs_recv")


def _jax_events(case, rank, b, cn):
    """One rank of a JAX body as (puts, notifies, waits, computes), each
    with its step (the arrival waits before it).  A put is (step, buffer,
    chunk or slot, destination rank); a compute (step, "matmul", the weight
    column chunk it reads), (step, "gate_up", "g" or "u"), (step, "swiglu")
    or (step, "reduce", the output chunk the last add writes)."""
    _, thunk = case.make(rank)
    rec = record.record_kernel(thunk, n=case.n, rank=rank)
    puts, notes, waits, comps, step = [], [], [], [], 0
    for ev in rec.events:
        if isinstance(ev, CopyEv):
            d = ev.dst
            if d.buffer in ("out", "red_buf"):
                puts.append((step, "out", d.bounds[0][0] // b, ev.dst_rank))
            elif d.buffer == "recv_buf":
                puts.append((step, "recv", d.bounds[0][0], ev.dst_rank))
        elif isinstance(ev, ComputeEv):
            if ev.kind == "matmul" and ev.write.buffer in ("g_buf", "u_buf"):
                comps.append((step, "gate_up", ev.write.buffer[0]))
            elif ev.kind == "matmul" and ev.write.buffer == "mm_buf":
                comps.append((step, "matmul", ev.reads[1].bounds[-1][0] // cn))
            elif ev.kind == "swiglu":
                comps.append((step, "swiglu"))
            elif ev.kind == "add" and ev.write.buffer in ("out", "red_buf"):
                comps.append((step, "reduce", ev.write.bounds[0][0] // b))
        elif isinstance(ev, NotifyEv):
            name, idx = ev.sem
            notes.append((step, _SEMS[name], idx or 0, ev.target))
        elif isinstance(ev, WaitEv):
            name, idx = ev.sem
            if name not in _SEMS:
                continue
            flag = _SEMS[name]
            waits.append((step, flag, idx or 0, ev.amount if ev.unit == "count" else 1))
            if flag in _ARRIVALS:
                step += 1
    return puts, notes, waits, comps


def _port_events(prog):
    puts, notes, waits, comps, step = [], [], [], [], 0
    for op in prog:
        if isinstance(op, Put):
            buf = "out" if op.dst.startswith("red") or op.dst == "out" else op.dst
            puts.append((step, buf, op.index, op.dst_rank))
        elif isinstance(op, Matmul):
            comps.append((step, "gate_up", op.dst[0]) if op.dst[0] in ("g", "u")
                         else (step, "matmul", op.w[1]))
        elif isinstance(op, Swiglu):
            comps.append((step, "swiglu"))
        elif isinstance(op, Reduce):
            comps.append((step, "reduce", op.dst[1]))
        elif isinstance(op, Notify):
            notes.append((step, op.flag[0], op.flag[1], op.target))
        elif isinstance(op, Wait):
            waits.append((step, op.flag[0], op.flag[1], op.count))
            if op.flag[0] in _ARRIVALS:
                step += 1
    return puts, notes, waits, comps


def _team(n):
    return Team((("tp", n),), "tp")


@pytest.mark.parametrize("n", (2, 3, 4))
def test_fused_ar_schedules_equal_jax_recorder(n):
    """K15's two bodies (swiglu, linear): every rank's puts, ACK and barrier
    credits, waits (the ACK drain for n = 2, 3 and >= 4 among them) and
    products, each at the same step, as JAX records them: the SwiGLU
    prologue before the entry barrier, each column chunk's product before
    the arrival wait of its step."""
    cases = {c.name: c for c in registry._fused_mlp_ar_cases(n)}
    for name, swiglu in (("fused_mlp_ar/swiglu", True), ("fused_mlp_ar/linear", False)):
        for rank in range(n):
            want = _jax_events(cases[name], rank, b=2, cn=4)
            got = _port_events(FD.ar_program(_team(n), rank, swiglu))
            for what, w, g in zip(("puts", "notifies", "waits", "computes"), want, got):
                assert g == w, f"{name} n={n} rank {rank}: {what} differ"
        progs = [FD.ar_program(_team(n), r, swiglu) for r in range(n)]
        walk(progs, None)   # no deadlock, every flag back at zero
        order = [c for _, k, *c in _port_events(progs[0])[3] if k == "matmul"]
        assert sorted(x[0] for x in order) == list(range(n))


@pytest.mark.parametrize("n", (2, 3, 4))
def test_fused_ar_oneshot_schedule_is_k11_one_shot(n):
    """K15's one-shot form (both bodies; K14's at decode sizes is the
    linear one): [the SwiGLU prologue,] one product of the whole partial
    into the product entry, then exactly ``comm/allreduce.py::
    one_shot_program``'s events (held to JAX's ``_ar_one_shot_kernel``
    recorder case by ``tests/test_torch_comm.py``): the push of that entry,
    its credits and waits and the slot-order f32 sum; the walk of every
    rank's program balances every credit."""
    team = _team(n)
    for swiglu in (True, False):
        for rank in range(n):
            prog = FD.oneshot_program(team, rank, swiglu)
            products = [op for op in prog if isinstance(op, (Matmul, Swiglu))]
            assert products[-1] == Matmul(("x", 0), ("act" if swiglu else "a", 0), ("w", 0))
            assert len(products) == (4 if swiglu else 1)
            assert prog[len(products):] == one_shot_program(team, rank)
        walk([FD.oneshot_program(team, r, swiglu) for r in range(n)], None)


@pytest.mark.parametrize("lanes", (1, 33, 132, 528))
def test_oneshot_plans_fit_the_staged_rows(lanes):
    """The one-shot form's product plans (``max_k_chunk=GEMV_STAGE_ROWS``,
    the rows of A a work item stages in shared memory, which
    ``csrc/fused_ar.cu`` checks): every K slice at most that many rows and
    a multiple of the 64-row granule, the slices covering K once; no fewer
    slices than the uncapped plan (the ring's and K16's, unchanged)."""
    for b, kd, cols in ((4, 1024, 4096), (4, 3072, 4096), (4, 4096, 6144), (1, 64, 8),
                        (5, 1032, 264), (3, 200, 48)):
        p = FD.gemv_plan(b, kd, cols, lanes, FD.GEMV_STAGE_ROWS)
        assert p.k_chunk <= FD.GEMV_STAGE_ROWS and p.k_chunk % 64 == 0
        assert (p.n_kslice - 1) * p.k_chunk < kd <= p.n_kslice * p.k_chunk
        assert (p.B, p.Kd, p.cols) == (b, kd, cols)
        assert p.n_kslice >= FD.gemv_plan(b, kd, cols, lanes).n_kslice


@pytest.mark.parametrize("n", (2, 4))
def test_persistent_schedule_equals_jax_recorder(n):
    """The whole persistent launch (two layers, four chained instances, the
    first unarmed): every rank's ordered events equal JAX's (the ring's
    puts, credits and waits, the MLP's gate/up products and SwiGLU, each
    chunk's product and last add); one entry barrier, 2 x 2 x 2 (n - 1) ring
    forwards, an armed drain before every instance but the first and one
    drain at exit; the walk of every rank's program balances every credit
    across the four instances."""
    (case,) = registry.cases_for("persistent_decode", n)
    layers, cn = 2, 8 // n
    for rank in range(n):
        want = _jax_events(case, rank, b=2, cn=cn)
        prog = PD.persistent_program(_team(n), rank, layers)
        got = _port_events(prog)
        for what, w, g in zip(("puts", "notifies", "waits", "computes"), want, got):
            assert g == w, f"n={n} rank {rank}: {what} differ"
        barriers = [op for op in prog if isinstance(op, Wait) and op.flag[0] == "barrier"]
        forwards = [op for op in prog if isinstance(op, Put) and op.dst_rank != rank]
        assert len(barriers) == 1 and len(forwards) == layers * 2 * 2 * (n - 1)
    walk([PD.persistent_program(_team(n), r, layers) for r in range(n)], None)


@pytest.mark.parametrize("n", (2, 4))
def test_oneshot_persistent_program_walks(n):
    """The served form's schedule (two layers, four chained one-shot
    instances): each instance is ``one_shot_program`` without its entry
    barrier (the same puts, slots and credits, the same waits, the slot-order
    f32 sum), into the landing of the instance's parity; every rank's walk
    ends with every credit taken and no deadlock, and no put lands on a slot
    not yet summed.  With one landing buffer the walk catches a fast rank's
    push of the next instance onto a slot a slow rank has not read."""
    team, layers = _team(n), 2
    progs = [PD.persistent_program(team, r, layers, form="oneshot") for r in range(n)]
    for r, prog in enumerate(progs):
        want = [op for op in one_shot_program(team, r)
                if not (isinstance(op, (Wait, Notify)) and op.flag[0] == "barrier")]
        puts = [op for op in prog if isinstance(op, (Put, Wait, Reduce))]
        assert len(puts) == 2 * layers * len(want)
        for inst in range(2 * layers):
            got = puts[inst * len(want):(inst + 1) * len(want)]
            slots = f"slots{inst % 2}"
            for g, w in zip(got, want):
                if isinstance(w, Put):
                    assert (g.dst, g.index, g.dst_rank, g.flag) == (slots, w.index, w.dst_rank,
                                                                    w.flag)
                elif isinstance(w, Wait):
                    assert g == w
                else:
                    assert g.srcs == tuple((slots, i) for i in range(n)) and g.f32
    walk(progs, None, unread=("slots0", "slots1"))
    one = [PD.persistent_program(team, r, layers, form="oneshot", buffers=1) for r in range(n)]
    with pytest.raises(RuntimeError, match="before it was read"):
        walk(one, None, unread=("slots0",))


def test_step_joins_from_the_schedules():
    """The rank-wide barriers a step passes, counted from each form's stage
    list: the served form 4 a layer and one at entry at any n (145 at 36
    layers), the ring body 10 + 2n a layer (433 at n = 1, 649 at n = 4)."""
    for n in (1, 2, 4):
        assert PD.step_joins("stream", 36, n) == 145
        assert PD.step_joins("ring", 36, n) == 1 + 36 * (10 + 2 * n)
    assert PD.step_stages("stream", 1, 1) == ["copy_in", "rank_sync", "qkv", "attention",
                                              "rank_sync", "o", "rank_sync", "gate_up",
                                              "rank_sync", "down", "rank_sync", "copy_out"]


@pytest.mark.parametrize("lanes", (132, 264, 528))
@pytest.mark.parametrize("n", (1, 4))
@pytest.mark.parametrize("width", ("8B", "narrow"))
def test_stream_plan_covers_every_column_once(width, n, lanes):
    """The served form's cut of the four products of Qwen3-8B at tp = n (and
    of ``chip_smoke.py``'s narrow persistent cases, hidden 512, whose
    products have fewer passes than the card has lanes) over a card of
    ``lanes`` lanes: every output column of every product in exactly one
    tile, a gate/up tile's 64 gate columns and the 64 up columns that match
    them, a qkv tile one head's 128 columns; the lanes' runs cover every
    pass once, in order, and differ by at most one pass; the lanes that sum
    a tile are exactly those whose runs hold its passes (the empty runs
    left out), and their partial slots (tile + lane) are distinct and
    inside the region."""
    k_dim, f, hk, g = (4096, 12288 // n, 8 // n, 4) if width == "8B" else (512, 1024 // n,
                                                                          4 // n, 4)
    per_rank = lanes // n
    ncols = {"qkv": (hk * g + 2 * hk) * 128, "o": k_dim, "gate_up": 2 * f, "down": k_dim}
    for product in PD.STREAM_PRODUCTS:
        geo = PD.stream_geometry(product, k_dim, f, hk, g, per_rank)
        cols = [c for t in range(geo["tiles"]) for c in PD.stream_tile_columns(geo, t)]
        assert sorted(cols) == list(range(ncols[product])), product
        for t in range(geo["tiles"]):
            tc = PD.stream_tile_columns(geo, t)
            if product == "gate_up":
                assert [c + f for c in tc[:64]] == tc[64:]
            elif product == "qkv":
                assert tc == list(range(t * 128, (t + 1) * 128))
        runs = geo["runs"]
        assert runs[0][0] == 0 and runs[-1][1] == geo["passes"]
        assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
        sizes = [q1 - q0 for q0, q1 in runs]
        assert max(sizes) - min(sizes) <= 1
        slots = set()
        for t in range(geo["tiles"]):
            holders = [ln for ln, (q0, q1) in enumerate(runs)
                       if q0 < q1 and q0 < (t + 1) * geo["ppt"] and q1 > t * geo["ppt"]]
            assert holders == PD.stream_tile_lanes(geo, t)
            slots |= {t + ln for ln in holders}
        assert len(slots) == sum(len(PD.stream_tile_lanes(geo, t)) for t in range(geo["tiles"]))
        tiles_max = max(hk * g + 2 * hk, k_dim // 128, f // 64)
        assert max(slots) < tiles_max + per_rank


# ---------------------------------------------------------------------------
# the ops' plain versions vs the XLA references


def _k15_limit(act, w, n, act_delta=None, hops=True):
    """Per element of the (B, N) result, the bf16 limit of the port's K15
    plain version against the XLA reference (f64 numpy), for activations
    ``act`` (n, B, F) and weights ``w`` (n, F, N): each chunk product
    rounded (2**-8 |value|, both sides: 2**-7), each ring hop's partial sum
    rounded, the f32 dots' order (2 (F + n) 2**-24 |A| |W|); the ring: chunk
    c's sum starts at rank c + 1 and travels right
    (``comm/ring.py::chunk_ar_phase``).  The swiglu form passes
    ``act_delta``, |the port's activation - JAX's| (each side's own
    roundings of g, u and SwiGLU), which moves the result by at most
    ``act_delta`` @ |down|.  ``hops`` False: the one-shot form (each
    partial rounded, then the f32 sum of the n of them once)."""
    u = 2.0 ** -8
    f = w.shape[1]
    act, w = act.astype(np.float64), w.astype(np.float64)
    parts = act @ w                                             # (n, B, N)
    s = (np.abs(act) @ np.abs(w)).sum(0)
    values = np.abs(parts).sum(0) + np.abs(parts.sum(0))
    cn = parts.shape[-1] // n
    for c in range(n if hops else 0):
        cols = slice(c * cn, (c + 1) * cn)
        acc = parts[(c + 1) % n][:, cols]
        for i in range(2, n + 1):
            acc = acc + parts[(c + i) % n][:, cols]
            values[:, cols] += np.abs(acc)
    limit = 2 * (f + n) * 2.0 ** -24 * s + 2 * u * (1 + 2.0 ** -5) * values
    if act_delta is not None:
        limit = limit + (1 + 2.0 ** -5) * (act_delta.astype(np.float64) @ np.abs(w)).sum(0)
    return limit, parts[0]


def _acts(x, gu_t, n, jdt):
    """(the port's, JAX's) SwiGLU activations of each rank, (n, B, F / n):
    the port's g and u rounded, silu(g) u in f32 rounded once
    (``ops/persistent_decode.py::_mlp_act``); JAX's as
    ``xla_fused_mlp_ar`` forms them (silu(g) and its product with u each
    in the operands' dtype)."""
    port = np.stack([PD._mlp_act(_t(x, gu_t.dtype), gu_t[r]).float().numpy() for r in range(n)])
    jax_acts = []
    for r in range(n):
        fused = jnp.dot(jnp.asarray(x, jdt), jnp.asarray(gu_t[r].float().numpy(), jdt),
                        preferred_element_type=jnp.float32).astype(jdt)
        wg, w1 = jnp.split(fused, 2, axis=-1)
        jax_acts.append(_np(jax.nn.silu(wg) * w1))
    return port, np.stack(jax_acts)


@pytest.mark.parametrize("n, method", [
    *[pytest.param(n, None, id=str(n)) for n in (2, 3, 4)],
    *[pytest.param(n, m, id=f"{n}-{FD.FORM_NAMES[m]}") for n in (2, 3, 4)
      for m in (AllReduceMethod.ONE_SHOT, AllReduceMethod.TWO_SHOT)]])
def test_fused_ar_ops_match_xla(n, method):
    """fused_mlp_ar and fused_linear_ar (plain versions, CPU tensors) on
    rank-stacked operands against xla_fused_mlp_ar and xla_gemm_ar for
    B = 1, 3, 4: f32 within 1e-5; bf16 within :func:`_k15_limit` (the
    per-rounding bound of ``tests/test_torch_tp.py::_ring_limits`` over
    column chunks), which a result with rank 0's partial left out fails 10x
    at its worst element.  ``method`` None: the public entries (the one-shot
    at these sizes); else the given form forced through the plain walk
    (``_walk_ar``), held to its own limit (the ring's hops, or none)."""
    rng = np.random.default_rng(40 + n)
    jm = jax_mesh({"tp": n}, devices=jax.devices()[:n])
    tm = tt.make_mesh({"tp": n}, device="cpu")
    k, f, cols = 32, 8 * n, 16 * n
    for b in (1, 3, 4):
        x = rng.standard_normal((b, k)).astype(np.float32)
        gu = (rng.standard_normal((k, 2 * f)) / np.sqrt(k)).astype(np.float32)  # rank-blocked
        dn = (rng.standard_normal((f, cols)) / np.sqrt(f)).astype(np.float32)
        h = rng.standard_normal((b, f)).astype(np.float32)
        for dt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
            if tdt == torch.bfloat16:
                x, gu, dn, h = (_np(jnp.asarray(a).astype(dt)) for a in (x, gu, dn, h))
            gu_t, dn_t = stack_columns(_t(gu, tdt), n), stack_rows(_t(dn, tdt), n)
            h_t = _t(h, tdt).reshape(b, n, f // n).permute(1, 0, 2).contiguous()
            for swiglu in (True, False):
                if swiglu:
                    want = _np(fallbacks.xla_fused_mlp_ar(jnp.asarray(x, dt), jnp.asarray(gu, dt),
                                                          jnp.asarray(dn, dt), jm, "tp"))
                    got = (tt.fused_mlp_ar(_t(x, tdt), gu_t, dn_t, tm) if method is None else
                           FD._walk_ar(True, _t(x, tdt), gu_t, dn_t, tm, "tp", tdt, method))
                else:
                    want = _np(fallbacks.xla_gemm_ar(jnp.asarray(h, dt), jnp.asarray(dn, dt), jm,
                                                     "tp"))
                    got = (tt.fused_linear_ar(h_t, dn_t, tm) if method is None else
                           FD._walk_ar(False, h_t, None, dn_t, tm, "tp", tdt, method))
                assert got.shape == (b, cols) and got.dtype == tdt
                got = got.float().numpy()
                if tdt == torch.float32:
                    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
                    continue
                hops = method != AllReduceMethod.ONE_SHOT
                if swiglu:
                    act, act_j = _acts(x, gu_t, n, dt)
                    lim, part0 = _k15_limit(act, dn_t.float().numpy(), n, np.abs(act - act_j),
                                            hops)
                else:
                    lim, part0 = _k15_limit(h_t.float().numpy(), dn_t.float().numpy(), n,
                                            hops=hops)
                assert np.all(np.abs(got - want) <= lim), np.max(np.abs(got - want) / lim)
                assert np.max(np.abs(got - part0 - want) / lim) >= 10


def test_fused_ar_refusals_and_one_rank():
    """Without a mesh or at one rank the plain products; a wire other than
    bf16 raises (B9); a config other than None and N not divisible by n
    raise.  Rows that are not 16-byte vectors are K15's limit, not the
    function's: on the CPU the plain version serves them (the card's
    refusal is chip_smoke.py's)."""
    x, gu, dn = torch.randn(3, 16), torch.randn(16, 16), torch.randn(8, 16)
    one = tt.make_mesh({"tp": 1}, device="cpu")
    want = torch.matmul(torch.nn.functional.silu(x @ gu[:, :8]) * (x @ gu[:, 8:]), dn)
    torch.testing.assert_close(tt.fused_mlp_ar(x, gu, dn), want)
    torch.testing.assert_close(tt.fused_mlp_ar(x, gu[None], dn[None], one), want)
    torch.testing.assert_close(tt.fused_linear_ar(x[:, :8], dn), x[:, :8] @ dn)
    tm = tt.make_mesh({"tp": 2}, device="cpu")
    gu2, dn2 = torch.randn(2, 16, 16), torch.randn(2, 8, 16)
    with pytest.raises(NotImplementedError, match="B9"):
        tt.fused_mlp_ar(x, gu2, dn2, tm, wire_dtype="int8")
    with pytest.raises(NotImplementedError, match="config=None"):
        tt.fused_mlp_ar(x, gu2, dn2, tm, config=(1, 2))
    with pytest.raises(ValueError, match="divisible"):
        tt.fused_linear_ar(torch.randn(2, 3, 8), torch.randn(2, 8, 15), tm)
    h, w = torch.randn(2, 3, 8), torch.randn(2, 8, 12)
    torch.testing.assert_close(tt.fused_linear_ar(h, w, tm), (h @ w).sum(0))


# ---------------------------------------------------------------------------
# the persistent step's plain version vs JAX's reference step


def _jax_stacked(params):
    return jax_qwen.stack_decode_params(jax.tree.map(jnp.asarray, params))


def _random_paged(rng, jm, n_layers):
    """A JAX paged cache of random f32 pools, ragged lengths with a position
    on a page boundary and one in the table's last page."""
    cache = jax_init_paged_cache(jm, n_layers, BATCH, JCFG.num_kv_heads, JCFG.max_length,
                                 JCFG.head_dim, JCFG.dtype, page_size=PAGE)
    mp = cache.block_table.shape[1]
    lens = np.array([PAGE, 3, mp * PAGE - 2, 2 * PAGE + 5], np.int32)
    return dataclasses.replace(
        cache, k=jnp.asarray(rng.standard_normal(cache.k.shape).astype(np.float32)),
        v=jnp.asarray(rng.standard_normal(cache.v.shape).astype(np.float32)),
        seq_lens=jnp.asarray(lens))


@pytest.mark.parametrize("n, orders", [(1, ("jax", "ring")), (4, ("jax", "ring")),
                                       (1, ("oneshot",)), (4, ("oneshot",))],
                         ids=["1", "4", "oneshot-1", "oneshot-4"])
def test_reference_step_matches_jax(jax_tp, n, orders):
    """The port's reference_decode_step in JAX's order (and, at n = 1, the
    CPU persistent step, which is it) on the rank-folded pools, against
    JAX's reference_decode_step on the same weights, pools and lengths:
    x_out and the unsharded pools within 1e-5 (f32).  The ring's order
    (the plain version of K16's f32 and head dim 64 body) and the one-shot
    order (both reductions in K15's one-shot form: the plain version of its
    served form) are within 1e-5 as well."""
    rng = np.random.default_rng(60 + n)
    jparams = jax_tp["params"] if n == N else jax_tp["params1"]
    jm = jax_mesh({"tp": n}, devices=jax.devices()[:n])
    jcache = _random_paged(rng, jm, JCFG.num_layers)
    x = rng.standard_normal((BATCH, JCFG.hidden)).astype(np.float32)
    kw = dict(rope_theta=JCFG.rope_theta, rms_eps=JCFG.rms_eps, qk_eps=JCFG.rms_eps)
    jx, jk, jv = jax_pd.reference_decode_step(jnp.asarray(x), _jax_stacked(jparams), jcache.k,
                                              jcache.v, jcache.block_table, jcache.seq_lens, n,
                                              **kw)
    tmesh = tt.make_mesh({"tp": n}, device="cpu") if n > 1 else None
    tparams = tt.from_jax_params(jparams, TCFG, "cpu", mesh=tmesh)
    sp = PD.stack_decode_params(tparams)
    for order in orders:
        cache = tt.from_jax_cache(jcache, "cpu", mesh=tmesh)
        if n == 1 and order == "jax":
            got, _, _ = tt.persistent_decode_step(_t(x), sp, cache.k, cache.v, cache.block_table,
                                                  cache.seq_lens, None, **kw)
        else:
            got, _, _ = PD.reference_decode_step(_t(x), sp, cache.k, cache.v, cache.block_table,
                                                 cache.seq_lens, tmesh, order=order, **kw)
        glob = tt.unshard_cache(cache, n)
        np.testing.assert_allclose(got.numpy(), _np(jx), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(glob.k.numpy(), _np(jk), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(glob.v.numpy(), _np(jv), atol=1e-5, rtol=1e-5)


def test_reference_step_walks_the_ring(jax_tp, monkeypatch):
    """K16 chains K15's ring instances at every size, so its plain version
    walks the ring form of both of its reductions each layer, though the
    size rule picks the one-shot for these partials: the one-shot walk is
    never reached."""
    from triton_distributed_tpu_torch.ops import fused_decode

    rng = np.random.default_rng(64)
    tmesh = tt.make_mesh({"tp": N}, device="cpu")
    assert FD.ar_method(BATCH * JCFG.hidden * 4, N) == AllReduceMethod.ONE_SHOT
    forms = []
    real = fused_decode._walk_ring

    def ring(*a, **k):
        forms.append("ring")
        return real(*a, **k)

    def oneshot(*a, **k):
        raise AssertionError("K16's plain version walked the one-shot form")

    monkeypatch.setattr(fused_decode, "_walk_ring", ring)
    monkeypatch.setattr(fused_decode, "walk_oneshot", oneshot)
    jcache = _random_paged(rng, jax_mesh({"tp": N}, devices=jax.devices()[:N]), JCFG.num_layers)
    cache = tt.from_jax_cache(jcache, "cpu", mesh=tmesh)
    sp = PD.stack_decode_params(tt.from_jax_params(jax_tp["params"], TCFG, "cpu", mesh=tmesh))
    x = _t(rng.standard_normal((BATCH, JCFG.hidden)).astype(np.float32))
    PD.reference_decode_step(x, sp, cache.k, cache.v, cache.block_table, cache.seq_lens, tmesh,
                             rope_theta=JCFG.rope_theta, rms_eps=JCFG.rms_eps,
                             qk_eps=JCFG.rms_eps)
    assert forms == ["ring"] * (2 * JCFG.num_layers)


# ---------------------------------------------------------------------------
# the model: the port's tp = 4 "fused" and "persistent" against JAX's


def _decode_golden(q, k, v, kv_len, **_):
    from triton_distributed_tpu.ops.attention import _xla_decode_fn

    b, h, d = q.shape
    fn = _xla_decode_fn(b, h, k.shape[1], k.shape[2], d, d ** -0.5, 0.0, jnp.dtype(q.dtype))
    return fn(q, k, v, kv_len)


def _gather(pool, block_table):   # (P, Hkv, ps, D) -> (B, Hkv, max_pages * ps, D)
    g = pool[block_table]
    return g.transpose(0, 2, 1, 3, 4).reshape(g.shape[0], g.shape[2], -1, g.shape[-1])


def _paged_golden(q, pool_k, pool_v, block_table, seq_lens, **_):
    return _decode_golden(q, _gather(pool_k, block_table), _gather(pool_v, block_table), seq_lens)


def _flash_golden(q, k, v, *, causal=True, sm_scale=None, **_):
    group = q.shape[1] // k.shape[1]
    k, v = jnp.repeat(k, group, axis=1), jnp.repeat(v, group, axis=1)
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    sc = jnp.einsum("bhqd,bhkd->bhqk", q.astype(jnp.float32), k.astype(jnp.float32)) * scale
    s_q, s_k = q.shape[2], k.shape[2]
    mask = jnp.arange(s_q)[:, None] + (s_k - s_q) >= jnp.arange(s_k)[None, :]
    p = jax.nn.softmax(jnp.where(mask, sc, -jnp.inf), axis=-1)
    return jnp.einsum("bhqk,bhkd->bhqd", p, v.astype(jnp.float32)).astype(q.dtype)


def _fused_attn_golden(x, wqkv, q_norm, k_norm, pool_k, pool_v, table, lens, *,
                       rope_theta, qk_eps=None, **_):
    """The attention megakernel's function in jnp, from JAX's pieces as
    ``reference_decode_step`` composes them (``persistent_decode.py:
    695-741``): the qkv product, qk-RMSNorm, RoPE at each sequence's
    position, the token into its page, the decode over the pages with it."""
    _, hk, ps, d = pool_k.shape
    b = x.shape[0]
    h = wqkv.shape[1] // d - 2 * hk
    qkv = jnp.dot(x, wqkv, preferred_element_type=jnp.float32).astype(x.dtype)
    q = qkv[:, :h * d].reshape(b, h, d)
    k = qkv[:, h * d:(h + hk) * d].reshape(b, hk, d)
    v = qkv[:, (h + hk) * d:].reshape(b, hk, d)
    if qk_eps is not None:
        q, k = jax_rms_norm(q, q_norm, qk_eps), jax_rms_norm(k, k_norm, qk_eps)
    pos = lens[:, None, None]
    q = jax_rope_at(q[:, :, None, :], pos, theta=rope_theta)[:, :, 0]
    k = jax_rope_at(k[:, :, None, :], pos, theta=rope_theta)[:, :, 0]
    pages = jnp.take_along_axis(table, (lens // ps)[:, None], axis=1)[:, 0]
    pool_k = pool_k.at[pages, :, lens % ps].set(k.astype(pool_k.dtype))
    pool_v = pool_v.at[pages, :, lens % ps].set(v.astype(pool_v.dtype))
    out = _paged_golden(q, pool_k, pool_v, table, lens + 1)
    return out.reshape(b, h * d), pool_k, pool_v


def _patched():
    """The XLA references and goldens under the names JAX's Qwen3 module
    uses (and ``ops/persistent_decode.py``'s entry)."""
    def ag(a, b, mesh, axis="tp", *, out_dtype=None, **_):
        return fallbacks.xla_ag_gemm(a, b, mesh, axis, out_dtype)

    def rs(a, b, mesh, axis="tp", *, out_dtype=None, **_):
        return fallbacks.xla_gemm_rs(a, b, mesh, axis, out_dtype)

    def mlp_ar(x, gate_up, down, mesh, axis="tp", *, out_dtype=None, **_):
        return fallbacks.xla_fused_mlp_ar(x, gate_up, down, mesh, axis, out_dtype)

    def linear_ar(h, w, mesh, axis="tp", *, out_dtype=None, **_):
        return fallbacks.xla_gemm_ar(h, w, mesh, axis, out_dtype)

    def persistent(x, sp, pool_k, pool_v, block_table, seq_lens, mesh, axis="tp", *,
                   config=None, **kw):
        return fallbacks.xla_persistent_decode(x, sp, pool_k, pool_v, block_table, seq_lens,
                                               mesh, axis, **kw)

    return ({"ag_gemm": ag, "gemm_rs": rs, "fused_mlp_ar": mlp_ar, "fused_linear_ar": linear_ar,
             "fused_attn_decode": _fused_attn_golden, "flash_attention": _flash_golden,
             "decode_attention": _decode_golden, "paged_decode_attention": _paged_golden},
            persistent)


def _prompt():
    return np.random.default_rng(7).integers(0, JCFG.vocab, (BATCH, PROMPT)).astype(np.int32)


def _jax_cache(mesh, layout):
    if layout == "paged":
        return jax_init_paged_cache(mesh, JCFG.num_layers, BATCH, JCFG.num_kv_heads,
                                    JCFG.max_length, JCFG.head_dim, JCFG.dtype, page_size=PAGE)
    return jax_init_cache(mesh, JCFG.num_layers, BATCH, JCFG.num_kv_heads, JCFG.max_length,
                          JCFG.head_dim, JCFG.dtype)


@pytest.fixture(scope="module")
def jax_tp():
    """The JAX Qwen3 at tp = 4 on the virtual CPU mesh, its Pallas ops
    replaced: prefill on both caches, then STEPS greedy steps in "fused"
    (both caches; "persistent" on a contiguous cache is the same chain) and
    in "persistent" (paged), each step's logits and the caches after them;
    and the tp = 4 weights re-fused for tp = 1."""
    ops, persistent = _patched()
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_qwen, jax_tp_mlp):
            for name, fn in ops.items():
                if hasattr(mod, name):
                    mp.setattr(mod, name, fn)
        mp.setattr(jax_pd, "persistent_decode_step", persistent)
        mesh = jax_mesh({"tp": N}, devices=jax.devices()[:N])
        models = {m: JaxQwen3(JCFG, mesh, decode_mode=m) for m in MODES}
        params = models["fused"].init(jax.random.key(3))
        ids = jnp.asarray(_prompt())
        out = {"params": jax.tree.map(np.asarray, params), "ids": np.array(ids)}
        jm1 = jax_mesh({"tp": 1}, devices=jax.devices()[:1])
        out["params1"] = jax.tree.map(np.asarray, JaxQwen3(JCFG, jm1).init(jax.random.key(5)))
        prefill = jax.jit(models["fused"].prefill)
        for layout in LAYOUTS:
            logits, cache = prefill(params, _jax_cache(mesh, layout), ids)
            tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
            out[layout] = {"first_token": np.asarray(tok), "steps": {}, "caches": {}}
            for mode in (MODES if layout == "paged" else ("fused",)):
                decode, c, t, logs = jax.jit(models[mode].decode), cache, tok, []
                for _ in range(STEPS):
                    lg, c = decode(params, c, t)
                    logs.append(_np(lg))
                    t = jnp.argmax(lg, axis=-1).astype(jnp.int32)
                out[layout]["steps"][mode] = logs
                out[layout]["caches"][mode] = jax.tree.map(np.asarray, c)
            if layout == "paged":
                toks, _ = jax.jit(models["persistent"].decode_multi, static_argnums=3)(
                    params, cache, tok, STEPS)
                out["paged"]["multi"] = np.asarray(toks)
    yield out


@pytest.fixture(scope="module")
def port_tp(jax_tp):
    mesh = tt.make_mesh({"tp": N}, device="cpu")
    return mesh, tt.from_jax_params(jax_tp["params"], TCFG, mesh=mesh)


def _port_cache(layout, tp):
    if layout == "paged":
        return tt.init_paged_cache(TCFG.num_layers, BATCH, TCFG.num_kv_heads, TCFG.max_length,
                                   TCFG.head_dim, TCFG.dtype, page_size=PAGE, device="cpu",
                                   tp=tp)
    return tt.init_cache(TCFG.num_layers, BATCH, TCFG.num_kv_heads, TCFG.max_length,
                         TCFG.head_dim, TCFG.dtype, device="cpu", tp=tp)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mode", MODES)
def test_modes_match_jax_tp4(jax_tp, port_tp, mode, layout):
    """The port at tp = 4 in "fused" and "persistent" on both caches against
    the JAX Qwen3 at tp = 4 in the same mode: prefill, then STEPS greedy
    steps, each step's logits within 1e-4, the greedy tokens equal, the
    unsharded cache after the steps within 1e-4 of JAX's; decode_multi's
    tokens equal the single steps' (and, paged, JAX's decode_multi)."""
    mesh, params = port_tp
    ref = jax_tp[layout]
    jmode = mode if layout == "paged" else "fused"
    model = tt.Qwen3(TCFG, mesh=mesh, decode_mode=mode)
    logits, cache = model.prefill(params, _port_cache(layout, N), torch.from_numpy(jax_tp["ids"]))
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    np.testing.assert_array_equal(tok.numpy(), ref["first_token"])
    start = dataclasses.replace(cache, k=cache.k.clone(), v=cache.v.clone(),
                                **({"seq_lens": cache.seq_lens.clone()} if layout == "paged"
                                   else {}))
    singles = []
    for want in ref["steps"][jmode]:
        lg, cache = model.decode(params, cache, tok)
        np.testing.assert_allclose(lg.numpy(), want, **TOL)
        tok = lg.argmax(-1).to(torch.int32)
        np.testing.assert_array_equal(tok.numpy(), want.argmax(-1))
        singles.append(tok)
    glob, jcache = tt.unshard_cache(cache, N), ref["caches"][jmode]
    np.testing.assert_allclose(glob.k.numpy(), _np(jcache.k), **TOL)
    np.testing.assert_allclose(glob.v.numpy(), _np(jcache.v), **TOL)
    multi, _ = model.decode_multi(params, start, torch.from_numpy(ref["first_token"]), STEPS)
    assert torch.equal(multi, torch.stack(singles))
    if layout == "paged" and mode == "persistent":
        np.testing.assert_array_equal(multi.numpy(), ref["multi"])


def test_engine_persistent_tp1_and_tp4(port_tp):
    """Engine.build serves "persistent" at tp = 1 and tp = 4 (paged: K16's
    path; contiguous: the "fused" chain), the layer table built once per
    parameters; at tp = 1 the greedy tokens equal "psum"'s."""
    mesh, params = port_tp
    ids = torch.from_numpy(_prompt())
    eng = tt.Engine(tt.Qwen3(TCFG, mesh=mesh, decode_mode="persistent"), params, batch=BATCH,
                    cache_layout="paged", page_size=PAGE)
    toks = eng.generate(ids, 3)
    assert toks.shape == (BATCH, 3) and eng.stacked() is eng.stacked()
    base = tt.Engine.build(TCFG, device="cpu", batch=BATCH, cache_layout="paged",
                           page_size=PAGE, generator=torch.Generator().manual_seed(2))
    want = base.generate(ids, 4)
    base.set_decode_mode("persistent")
    assert torch.equal(base.generate(ids, 4), want)
    base.prefill(ids)
    assert base.decode_multi(want[:, 0], 3).shape == (3, BATCH)


# ---------------------------------------------------------------------------
# refusals


def test_persistent_refusals(monkeypatch):
    """A persistent step on an int8 pool raises, as JAX's; the rank-folded
    attention megakernel on int8 pages raises (they serve tp = 1); MoE at
    tp > 1 raises; a config other than None raises; a CUDA request without
    CUDA raises."""
    g = torch.Generator().manual_seed(4)
    params = tt.Qwen3(TCFG, device="cpu").init(g)
    sp = tt.stack_decode_params(params)
    cache = tt.init_paged_cache(TCFG.num_layers, 2, TCFG.num_kv_heads, TCFG.max_length,
                                TCFG.head_dim, TCFG.dtype, page_size=PAGE, device="cpu",
                                kv_dtype="int8")
    x = torch.randn(2, TCFG.hidden)
    with pytest.raises(NotImplementedError, match="full-precision"):
        tt.persistent_decode_step(x, sp, cache.k, cache.v, cache.block_table, cache.seq_lens)
    cols = (TCFG.num_heads + 2 * TCFG.num_kv_heads) * TCFG.head_dim
    with pytest.raises(NotImplementedError, match="int8 pages at tp > 1"):
        tt.fused_attn_decode(x, torch.randn(1, TCFG.hidden, cols), None, None, cache.k[0],
                             cache.v[0], cache.block_table, cache.seq_lens,
                             k_scale=cache.k_scale[0], v_scale=cache.v_scale[0])
    cache = tt.init_paged_cache(TCFG.num_layers, 2, TCFG.num_kv_heads, TCFG.max_length,
                                TCFG.head_dim, TCFG.dtype, page_size=PAGE, device="cpu")
    with pytest.raises(NotImplementedError, match="config=None"):
        tt.persistent_decode_step(x, sp, cache.k, cache.v, cache.block_table, cache.seq_lens,
                                  config=object())
    mesh = tt.make_mesh({"tp": N}, device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        tt.Qwen3(dataclasses.replace(TCFG, num_experts=4, moe_intermediate=32), mesh=mesh,
                 decode_mode="persistent")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.Engine.build(TCFG, decode_mode="persistent")
