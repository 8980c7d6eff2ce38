"""The port's expert parallelism (the EP all-to-all K17, the wire pack K18,
``MoEMLP`` under EP, Qwen3-MoE at tp = 4 with ``moe_strategy="ep"``) and the
parity-slot ``AllGatherLayer`` against the JAX package, on the CPU.

The JAX Pallas collectives give no result in interpret mode within a test's
time here (``tests/test_torch_comm.py``), so the JAX side is held through
the package's own surfaces:

- the protocol recorder (``analysis/record.py::record_kernel`` over
  ``analysis/registry.py::_a2a_cases``: dispatch, combine and the scheduled
  emission order) against the port's push schedule
  (``comm/ring.py::a2a_push_phase``), copy for copy and wait for wait;
- ``resilience/fallbacks.py::xla_ep_dispatch`` and ``xla_ep_combine`` (the
  same zone layout built in jnp) against the plain versions, and in place of
  the Pallas entries under the names ``layers/moe.py`` and
  ``comm/all_to_all.py`` hold, inside the JAX ``MoEMLP`` and ``Qwen3``: a
  real JAX EP layer and model to hold the port's against, on the same
  weights (no JAX file changes; the attention kernels are swapped for their
  jnp goldens as in ``tests/test_torch_tp.py``);
- ``lang/quant.py::_pack_rows_xla`` (bit for bit) and the Pallas
  ``_build_pack`` in interpret mode (decoded, within ``abs_error_bound``)
  against the plain pack.

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

import triton_distributed_tpu.comm.all_to_all as jax_a2a
import triton_distributed_tpu.layers.moe as jax_moe
import triton_distributed_tpu.layers.tp_mlp as jax_tp_mlp
import triton_distributed_tpu.models.qwen as jax_qwen
from triton_distributed_tpu.analysis import record, registry
from triton_distributed_tpu.analysis.events import CopyEv, NotifyEv, WaitEv
from triton_distributed_tpu.comm.hierarchical import ici_schedule
from triton_distributed_tpu.core.mesh import make_mesh as jax_mesh
from triton_distributed_tpu.lang import quant as jq
from triton_distributed_tpu.layers.moe import MoEMLP as JaxMoEMLP
from triton_distributed_tpu.models import ModelConfig as JaxConfig
from triton_distributed_tpu.models import Qwen3 as JaxQwen3
from triton_distributed_tpu.models.kv_cache import init_paged_cache as jax_init_paged_cache
from triton_distributed_tpu.resilience import fallbacks
from triton_distributed_tpu.tools import calibrate as jax_calibrate

import triton_distributed_tpu_torch as tt
from triton_distributed_tpu_torch import comm
from triton_distributed_tpu_torch.comm import ring
from triton_distributed_tpu_torch.lang import quant as tq
from triton_distributed_tpu_torch.lang.primitives import Notify, Put, Team, Wait
from triton_distributed_tpu_torch.ops.group_gemm import grouped_matmul
from triton_distributed_tpu_torch.ops.moe_utils import flatten_topk, sort_by_expert, topk_route

from test_torch_tp import _patched_ops

N = 4
E, TOP_K, HIDDEN, FFN = 16, 2, 64, 32
# f32 layer and model: the two frameworks sum in other orders
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-3, rtol=1e-3)


def _np(x):
    return np.asarray(jax.device_get(x)).astype(np.float32)


def _bf16_bits(a):
    """f32 numpy values as (jnp bf16, torch bf16) holding the same bits."""
    j = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    t = torch.from_numpy(np.asarray(j).view(np.uint16).copy()).view(torch.bfloat16)
    return j, t


class _MeshShape:
    """What ``xla_ep_dispatch``/``xla_ep_combine`` read of a mesh."""

    def __init__(self, n):
        self.shape = {"tp": n}


# ---------------------------------------------------------------------------
# K17's schedule against the JAX recorder


def _offsets(row):
    return [int(v) for v in np.cumsum([0, *row[:-1]])]


def _jax_a2a(case, rank, chunk):
    """(puts, notifies, waits) of one rank: a put (first source row, zone,
    chunk of the zone, destination rank); barrier credits (target); waits
    (flag, index, count).  Send-semaphore waits have no counterpart."""
    _, thunk = case.make(rank)
    rec = record.record_kernel(thunk, n=case.n, rank=rank)
    puts, notes, waits = [], [], []
    for ev in rec.events:
        if isinstance(ev, CopyEv):
            zone, rows = ev.dst.bounds[0][0], ev.dst.bounds[1][0]
            puts.append((ev.src.bounds[0][0], zone, rows // chunk, ev.dst_rank))
        elif isinstance(ev, NotifyEv):
            notes.append(("barrier", ev.target))
        elif isinstance(ev, WaitEv):
            name, idx = ev.sem
            if name == "recv_sems":
                waits.append(("recv", idx, 1))
            elif name == "<collective_barrier>":
                waits.append(("barrier", 0, ev.amount))
    return puts, notes, waits


def _port_a2a(n, rank, send, offs, expected, chunk, order):
    prog = []
    ring.a2a_push_phase(prog, Team((("tp", n),), "tp"), rank, send, expected, chunk, order)
    puts, notes, waits = [], [], []
    for op in prog:
        if isinstance(op, Put):
            dst, c = op.srcs[0][1]
            zone, zc = op.index
            assert op.flag == ("recv", rank) and zone == rank and zc == c
            puts.append((offs[dst] + c * chunk, zone, c, op.dst_rank))
        elif isinstance(op, Notify):
            notes.append((op.flag[0], op.target))
        elif isinstance(op, Wait):
            waits.append((*op.flag, op.count))
    return puts, notes, waits


@pytest.mark.parametrize("n", (2, 3, 4))
def test_a2a_schedule_equals_jax_recorder(n):
    """Every rank of the three cases (dispatch, combine with the roles
    swapped, the farthest-first emission order): the same copies (source
    rows, zone, chunk, destination), the same barrier credits and the same
    waits, in order, as JAX records them."""
    chunk, z = 2, 8   # the registry cases'
    counts = registry._a2a_counts(n)
    cases = {c.name: c for c in registry._a2a_cases(n)}
    for rank in range(n):
        received = [counts[p][rank] for p in range(n)]
        port = {
            "all_to_all/dispatch": (counts[rank], _offsets(counts[rank]), received, None),
            "all_to_all/combine": (received, [p * z for p in range(n)], counts[rank], None),
            "all_to_all/scheduled": (counts[rank], _offsets(counts[rank]), received,
                                     tuple(ici_schedule(n))),
        }
        for name, (send, offs, expected, order) in port.items():
            want = _jax_a2a(cases[name], rank, chunk)
            got = _port_a2a(n, rank, send, offs, expected, chunk, order)
            for what, w, g in zip(("copies", "credits", "waits"), want, got):
                assert g == w, f"{name} n={n} rank {rank}: {what} differ"
    assert set(cases) == {"all_to_all/dispatch", "all_to_all/combine", "all_to_all/scheduled"}


# ---------------------------------------------------------------------------
# the plain dispatch and combine against the XLA references


def _splits(rng, n, t, e, mode):
    out = np.zeros((n, e), np.int32)
    for r in range(n):
        tot = t if mode != "short" else int(rng.integers(0, t + 1))
        if mode == "one_peer":          # every row to rank n - 1's first expert
            ids = np.full(tot, e - e // n)
        elif mode == "silent" and r == 1:   # a rank that sends nothing
            ids = np.zeros(0, int)
        elif mode == "empty_experts":   # half the experts get nothing
            ids = rng.integers(0, e // 2, tot) * 2
        else:
            ids = rng.integers(0, e, tot)
        out[r] = np.bincount(ids, minlength=e)
    return out


@pytest.mark.parametrize("n", (2, 3, 4))
def test_plain_a2a_equals_xla(n):
    """ep_dispatch / ep_combine on CPU tensors (the schedule walked) against
    xla_ep_dispatch / xla_ep_combine: zones (valid rows and the zero tails),
    recv_splits and Z equal; combine's rows below each rank's real total
    equal; T 1, 37, 200; uniform, every row to one peer, a silent rank,
    empty experts, short totals; f32, bf16 and u8 rows; bitwise."""
    rng = np.random.default_rng(100 + n)
    tm = tt.make_mesh({"tp": n}, device="cpu")
    e, h = 2 * n, 16
    for t in (1, 37, 200):
        for mode in ("uniform", "one_peer", "silent", "empty_experts", "short"):
            spl = _splits(rng, n, t, e, mode)
            jspl = jnp.asarray(spl.reshape(-1))
            tspl = torch.from_numpy(spl)
            x = rng.standard_normal((n, t, h)).astype(np.float32)
            for kind in ("f32", "bf16", "u8"):
                if kind == "bf16":
                    jx, tx = _bf16_bits(x)
                elif kind == "u8":
                    u = rng.integers(0, 256, (n, t, h), dtype=np.uint8)
                    jx, tx = jnp.asarray(u), torch.from_numpy(u)
                else:
                    jx, tx = jnp.asarray(x), torch.from_numpy(x)
                jr, js = fallbacks.xla_ep_dispatch(jx.reshape(n * t, h), jspl, _MeshShape(n),
                                                   "tp")
                tr, ts = comm.ep_dispatch(tx, tspl, tm, "tp")
                jr = np.asarray(jr).reshape(n, n, -1, h)
                assert tr.shape == jr.shape and tr.dtype == tx.dtype
                got = tr.view(torch.uint16).numpy() if kind == "bf16" else tr.numpy()
                want = jr.view(np.uint16) if kind == "bf16" else jr
                np.testing.assert_array_equal(got, want, err_msg=f"{t} {mode} {kind}")
                np.testing.assert_array_equal(ts.numpy(), np.asarray(js).reshape(n, n, -1))
                want_c = np.asarray(fallbacks.xla_ep_combine(
                    jnp.asarray(jr.reshape(n * n, -1, h)), jspl, _MeshShape(n), "tp",
                    token_dim=t)).reshape(n, t, h)
                got_c = comm.ep_combine(tr, tspl, tm, "tp", token_dim=t)
                got_c = got_c.view(torch.uint16).numpy() if kind == "bf16" else got_c.numpy()
                if kind == "bf16":
                    want_c = want_c.view(np.uint16)
                for r, total in enumerate(spl.sum(1)):
                    np.testing.assert_array_equal(got_c[r, :total], want_c[r, :total])
                # the round trip gives every real row back
                for r, total in enumerate(spl.sum(1)):
                    got_x = got_c[r, :total]
                    ref_x = (tx.view(torch.uint16).numpy() if kind == "bf16"
                             else tx.numpy())[r, :total]
                    np.testing.assert_array_equal(got_x, ref_x)


def test_a2a_single_rank_and_refusals():
    """n == 1 is JAX's shortcut; the int8 and fp8 wires move codec round
    trips; a tuple axis, wire "auto", a schedule that is no permutation and
    experts that do not divide raise."""
    one = tt.make_mesh({"tp": 1}, device="cpu")
    x, spl = torch.randn(1, 6, 16), torch.tensor([[2, 4]], dtype=torch.int32)
    recv, rs = comm.ep_dispatch(x, spl, one, "tp")
    assert recv.shape == (1, 1, 6, 16) and torch.equal(recv[0, 0], x[0])
    assert torch.equal(rs, spl[:, None])
    assert torch.equal(comm.ep_combine(recv, spl, one, "tp", token_dim=6), x)
    tm = tt.make_mesh({"tp": 2}, device="cpu")
    x2, s2 = torch.randn(2, 4, 16), torch.tensor([[1, 1, 1, 1]] * 2, dtype=torch.int32)
    # the quantized wire: the zones and the combined rows are the plain
    # exchange of the rows one codec round trip makes
    for wire in ("fp8", "int8"):
        rt = tq.dequantize_rows(*tq.quantize_rows(x2, wire), x2.dtype)
        recv8, _ = comm.ep_dispatch(x2, s2, tm, "tp", wire_dtype=wire)
        assert torch.equal(recv8[:, :, :2], comm.ep_dispatch(rt, s2, tm, "tp")[0][:, :, :2])
        back8 = comm.ep_combine(recv8, s2, tm, "tp", token_dim=4, wire_dtype=wire)
        assert torch.equal(back8, tq.dequantize_rows(*tq.quantize_rows(rt, wire), x2.dtype))
    with pytest.raises(NotImplementedError, match="A5"):
        comm.ep_dispatch(x2, s2, tm, "tp", wire_dtype="auto")
    with pytest.raises(NotImplementedError, match="tuple axis"):
        comm.ep_dispatch(x2, s2, tm, ("tp", "tp"))
    with pytest.raises(ValueError, match="permutation"):
        comm.ep_dispatch(x2, s2, tm, "tp", config=comm.AllToAllConfig(schedule=(0, 0)))
    with pytest.raises(ValueError, match="divide"):
        comm.ep_dispatch(x2, s2[:, :3], tm, "tp")


# ---------------------------------------------------------------------------
# the wire pack


def _pack_rows():
    """Randn rows, an all-zero row, an all-negative row, a denormal-range
    row, a row with one element at 1e4."""
    x = np.random.default_rng(7).standard_normal((128, 256)).astype(np.float32)
    x[0] = 0.0
    x[1] = -np.abs(x[1])
    x[2] *= 1e-40
    x[3, 17] = 1e4
    return x


@pytest.mark.parametrize("wire", ("fp8", "int8"))
def test_plain_pack_equals_jax(wire):
    """pack_rows / unpack_rows on the CPU equal JAX's _pack_rows_xla /
    unpack_rows bit for bit (f32 and bf16 rows).  Decoded, they are within
    abs_error_bound of JAX's Pallas _build_pack (interpret mode), whose
    scale absmax * (1/qmax) may sit one ulp from the IEEE quotient the XLA
    producer and the port take: the test states that one-ulp difference."""
    x = _pack_rows()
    for dt in ("f32", "bf16"):
        jx, tx = _bf16_bits(x) if dt == "bf16" else (jnp.asarray(x), torch.from_numpy(x))
        want = np.asarray(jq._pack_rows_xla(jx, wire))
        got = tq.pack_rows(tx, wire)
        assert got.dtype == torch.uint8 and got.shape == (128, 256 + tq.SIDECAR)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=dt)
        dec = tq.unpack_rows(got, 256, wire, torch.float32).numpy()
        np.testing.assert_array_equal(dec, np.asarray(jq.unpack_rows(jnp.asarray(want), 256,
                                                                    wire, jnp.float32)))
        np.testing.assert_array_equal(got[:, 260:].numpy(), 0)
    # against the Pallas producer on the same bf16 rows: scales at most one
    # ulp apart, decoded values within the codec's envelope of the input
    pallas = np.asarray(jq._build_pack(128, 256, wire)(jx))
    s_port = got.numpy()[:, 256:260].copy().view(np.float32)[:, 0]
    s_pal = pallas[:, 256:260].copy().view(np.float32)[:, 0]
    ulps = np.abs(s_port.view(np.int32).astype(np.int64) - s_pal.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    xf = _np(jx)
    # the envelope, plus the f32 rounding of the decoded product q * scale
    # (an int8 half-step tie lands on the envelope itself)
    bound = jq.abs_error_bound(np.abs(xf).max(1, keepdims=True), wire) + 2.0 ** -23 * np.abs(xf)
    dec_pal = _np(jq.unpack_rows(jnp.asarray(pallas), 256, wire, jnp.float32))
    assert np.all(np.abs(dec - xf) <= bound) and np.all(np.abs(dec_pal - xf) <= bound)
    assert np.all(np.abs(dec - dec_pal) <= 2 * bound)
    # the all-zero row round-trips exactly, the moe_utils aliases are quant's
    assert np.all(dec[0] == 0)
    q, s = tt.ops.moe_utils.quantize_e4m3(torch.from_numpy(x))
    assert torch.equal(tt.ops.moe_utils.dequantize(q, s, torch.float32),
                       tq.dequantize_rows(*tq.quantize_rows(torch.from_numpy(x)), torch.float32))


# ---------------------------------------------------------------------------
# MoEMLP under EP against the JAX layer


def _xla_a2a():
    """The XLA references under the names the JAX layer and its quantized
    transports import."""
    def dispatch(x, splits, mesh, axis="tp", *, config=None, **_):
        return fallbacks.xla_ep_dispatch(x, splits, mesh, axis, config=config)

    def combine(y, splits, mesh, axis="tp", *, token_dim, config=None, **_):
        return fallbacks.xla_ep_combine(y, splits, mesh, axis, token_dim=token_dim,
                                        config=config)

    return {"ep_dispatch": dispatch, "ep_combine": combine}


@pytest.fixture(scope="module")
def meshes():
    return jax_mesh({"tp": N}, devices=jax.devices()[:N]), tt.make_mesh({"tp": N}, device="cpu")


@pytest.fixture(scope="module")
def ep_layer(meshes):
    """The JAX EP layer (XLA all-to-all in place of the Pallas one) on a
    4-rank CPU mesh: forward_ep with the bf16 and the fp8 wire, and
    forward_replicated_ep; the weights and inputs as numpy."""
    jm, _ = meshes
    rng = np.random.default_rng(11)
    x = rng.standard_normal((32, HIDDEN)).astype(np.float32)
    xd = rng.standard_normal((5, HIDDEN)).astype(np.float32)
    out = {"x": x, "xd": xd}
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_moe, jax_a2a):
            for name, fn in _xla_a2a().items():
                mp.setattr(mod, name, fn)
        for wire in (False, True):
            layer = JaxMoEMLP(jm, num_experts=E, top_k=TOP_K, swiglu=True, fp8_wire=wire)
            params = layer.init(jax.random.key(3), HIDDEN, FFN, ep=True, dtype=jnp.float32)
            out[("ep", wire)] = _np(jax.jit(layer.forward_ep)(params, jnp.asarray(x)))
        out["rep"] = _np(jax.jit(layer.forward_replicated_ep)(params, jnp.asarray(xd)))
        out["params"] = [np.asarray(a) for a in (params.router, params.w_up, params.w_dn)]
    return out


def _port_layer(tm, fp8_wire=False):
    return tt.MoEMLP(num_experts=E, top_k=TOP_K, swiglu=True, fp8_wire=fp8_wire, mesh=tm,
                     axis="tp")


def test_moe_ep_layer_matches_jax(meshes, ep_layer):
    """forward_ep (bf16 and fp8 wire) and forward_replicated_ep at n = 4,
    E = 16, top-2, hidden 64, f32, against the JAX layer within 1e-5 (sums
    in other orders).  The fp8 wire packs the same bytes on both sides (the
    plain pack is JAX's bit for bit), so it is held as tightly."""
    _, tm = meshes
    router, w_up, w_dn = (torch.from_numpy(a) for a in ep_layer["params"])
    for wire in (False, True):
        layer = _port_layer(tm, wire)
        params = layer.shard_params_ep(router, w_up, w_dn)
        assert params.w_up is w_up and params.w_dn is w_dn   # the tp = 1 tensors, no copy
        got = layer.forward_ep(params, tt.shard(tm, torch.from_numpy(ep_layer["x"])))
        assert got.shape == (N, 32 // N, HIDDEN) and got.dtype == torch.float32
        np.testing.assert_allclose(tt.unshard(tm, got).numpy(), ep_layer[("ep", wire)],
                                   **LAYER_TOL, err_msg=f"fp8_wire={wire}")
    got = layer.forward_replicated_ep(params, torch.from_numpy(ep_layer["xd"]))
    np.testing.assert_allclose(got.numpy(), ep_layer["rep"], **LAYER_TOL)


def test_moe_ep_decode_leaves_parked_rows_out(meshes):
    """JAX's decode parks each rank's foreign rows on local expert 0 with
    weight 0, multiplies them and discards them; the port leaves them out.
    The parked computation, made here with the port's own ops rank by rank
    (psum of the ranks' partials in f32, rounded once), gives the same
    result (in bf16, where a parked row's 0 * y would show as a rounding)."""
    _, tm = meshes
    g = torch.Generator().manual_seed(5)
    layer = _port_layer(tm)
    params = layer.init(g, HIDDEN, FFN, ep=True, dtype=torch.bfloat16, scale=0.2)
    x = torch.randn((6, HIDDEN), generator=g).to(torch.bfloat16)
    got = layer.forward_replicated_ep(params, x)
    epr = E // N
    eid, wts = topk_route(x @ params.router, TOP_K)
    xr, eflat, wflat = flatten_topk(x, eid, wts)
    parts = []
    for r in range(N):
        local = eflat - r * epr
        owned = (local >= 0) & (local < epr)
        w_r = torch.where(owned, wflat, torch.zeros_like(wflat))
        xs, splits, unsort = sort_by_expert(xr, torch.where(owned, local, 0).int(), epr)
        mine = slice(r * epr, (r + 1) * epr)
        h = layer._combine(grouped_matmul(xs, params.w_up[mine], splits))
        y = grouped_matmul(h, params.w_dn[mine], splits).index_select(0, unsort)
        parts.append((y.reshape(6, TOP_K, -1) * w_r.reshape(6, TOP_K, 1).to(y.dtype)).sum(1))
    want = torch.stack(parts).float().sum(0).to(torch.bfloat16)
    assert torch.equal(got, want)


def test_fp8_wire_auto_and_weights(meshes, jax_ep):
    """fp8_wire="auto" resolves to False on both sides (the port's
    co-located ranks; JAX's cold start on a single-slice mesh, wire class
    "ici"); the EP weights carry across from_jax_params as they are: rank
    r's experts are rows [r E/n, (r + 1) E/n) of the one (E, ...) tensor,
    as JAX's P(axis, None, None) shards them."""
    jm, tm = meshes
    assert not _port_layer(tm, "auto").fp8_wire_enabled()
    assert not JaxMoEMLP(jm, num_experts=E, fp8_wire="auto").fp8_wire_enabled(HIDDEN)
    assert not jax_calibrate.codec_pays("ici", h=2048)
    # JAX's P(axis, None, None) expert shards, gathered, are the port's tensors
    for jl, tl in zip(jax_ep["params"].layers, tt.from_jax_params(jax_ep["params"], TCFG,
                                                                  mesh=tm).layers):
        for f in ("router", "w_up", "w_dn"):
            np.testing.assert_array_equal(getattr(tl.mlp, f).numpy(), getattr(jl.mlp, f))


# ---------------------------------------------------------------------------
# Qwen3-MoE at tp = 4 under EP against the JAX model

JCFG = JaxConfig(
    num_layers=2, hidden=HIDDEN, intermediate=128, num_heads=8, num_kv_heads=4, head_dim=16,
    vocab=256, max_length=64, rope_theta=1e6, rms_eps=1e-6, dtype=jnp.float32,
    num_experts=E, top_k=TOP_K, moe_intermediate=FFN, moe_strategy="ep")
TCFG = tt.ModelConfig(**{
    f.name: getattr(JCFG, f.name) for f in dataclasses.fields(JCFG)
    if f.name != "dtype"}, dtype=torch.float32)
BATCH, PROMPT, STEPS, PAGE = 4, 8, 3, 16


@pytest.fixture(scope="module")
def jax_ep(meshes):
    """The JAX Qwen3-MoE at tp = 4 under EP on the CPU mesh (XLA all-to-all,
    jnp attention goldens): paged prefill logits and STEPS greedy "psum"
    decode steps, for the bf16 and the fp8 wire, from one seed."""
    jm, _ = meshes
    ids = np.random.default_rng(9).integers(0, JCFG.vocab, (BATCH, PROMPT)).astype(np.int32)
    out = {"ids": ids}
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_qwen, jax_tp_mlp):
            for name, fn in _patched_ops().items():
                if hasattr(mod, name):
                    mp.setattr(mod, name, fn)
        for mod in (jax_moe, jax_a2a):
            for name, fn in _xla_a2a().items():
                mp.setattr(mod, name, fn)
        for wire in (False, True):
            model = JaxQwen3(dataclasses.replace(JCFG, moe_fp8_wire=wire), jm)
            params = model.init(jax.random.key(0))
            cache = jax_init_paged_cache(jm, JCFG.num_layers, BATCH, JCFG.num_kv_heads,
                                         JCFG.max_length, JCFG.head_dim, JCFG.dtype,
                                         page_size=PAGE)
            logits, cache = jax.jit(model.prefill)(params, cache, jnp.asarray(ids))
            logs = [_np(logits)]
            tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
            decode = jax.jit(model.decode)
            for _ in range(STEPS):
                lg, cache = decode(params, cache, tok)
                logs.append(_np(lg))
                tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
            out[wire] = logs
        out["params"] = jax.tree.map(np.asarray, params)
    return out


@pytest.mark.parametrize("mode", ("psum", "fused"))
def test_qwen_ep_tp4_matches_jax(meshes, jax_ep, mode):
    """The port's Qwen3-MoE at tp = 4 with moe_strategy="ep" (2 layers,
    f32, E = 16, top-2) on JAX's weights: prefill logits and each greedy
    decode step's logits within 1e-3 of the JAX model's (its "psum" decode
    is the reference of both port modes), greedy tokens equal; with the fp8
    wire likewise against the JAX fp8 model.  The fp8 logits stay within
    the codec's envelope of the bf16 wire's: 2 x 2^-4 (a relative 2^-4 on
    each of the two hops) of the logits' absmax."""
    _, tm = meshes
    ids = torch.from_numpy(jax_ep["ids"])
    first = {}
    for wire in (False, True):
        cfg = dataclasses.replace(TCFG, moe_fp8_wire=wire)
        params = tt.from_jax_params(jax_ep["params"], cfg, mesh=tm)
        assert params.layers[0].mlp.w_up.shape == (E, HIDDEN, 2 * FFN)
        model = tt.Qwen3(cfg, mesh=tm, decode_mode=mode)
        cache = tt.init_paged_cache(cfg.num_layers, BATCH, cfg.num_kv_heads, cfg.max_length,
                                    cfg.head_dim, cfg.dtype, page_size=PAGE, device="cpu",
                                    tp=N)
        want = jax_ep[wire]
        logits, cache = model.prefill(params, cache, ids)
        np.testing.assert_allclose(logits.numpy(), want[0], **LOGIT_TOL)
        first[wire] = logits.numpy()
        tok = torch.from_numpy(want[0][:, -1].argmax(-1).astype(np.int32))
        for step in range(STEPS):
            lg, cache = model.decode(params, cache, tok)
            np.testing.assert_allclose(lg.numpy(), want[step + 1], **LOGIT_TOL,
                                       err_msg=f"fp8_wire={wire} step {step}")
            np.testing.assert_array_equal(lg.argmax(-1).numpy(), want[step + 1].argmax(-1))
            tok = torch.from_numpy(want[step + 1].argmax(-1).astype(np.int32))
    gap = np.abs(first[True] - first[False]).max()
    assert 0 < gap <= 2 * tq.rel_error_bound("fp8") * np.abs(first[False]).max()


def test_qwen_ep_tp1_and_shard_params():
    """moe_strategy="ep" at tp = 1 is JAX's one-rank shortcut: the same
    logits as the TP strategy on the same draw; Qwen3.shard_params takes a
    tp = 1 draw to tp = 4 EP with the experts' tensors kept (no copy)."""
    g = torch.Generator().manual_seed(2)
    tp1 = tt.Qwen3(dataclasses.replace(TCFG, moe_strategy="tp"), device="cpu")
    params = tp1.init(g)
    ep1 = tt.Qwen3(TCFG, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, TCFG.vocab, (2, 8)))

    def cache(tp=1):
        return tt.init_paged_cache(TCFG.num_layers, 2, TCFG.num_kv_heads, TCFG.max_length,
                                   TCFG.head_dim, TCFG.dtype, page_size=PAGE, device="cpu",
                                   tp=tp)

    want, _ = tp1.prefill(params, cache(), ids)
    got, _ = ep1.prefill(ep1.shard_params(params), cache(), ids)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    tm = tt.make_mesh({"tp": N}, device="cpu")
    ep4 = tt.Qwen3(TCFG, mesh=tm)
    p4 = ep4.shard_params(params)
    assert p4.layers[0].mlp.w_up.data_ptr() == params.layers[0].mlp.w_up.data_ptr()
    got4, _ = ep4.prefill(p4, cache(N), ids)
    torch.testing.assert_close(got4, want, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the parity-slot AllGather layer


def test_allgather_layer_alternates_slots():
    """Two parity workspaces, made once: calls alternate them, call k's
    result stays intact through call k + 1 and is overwritten by call
    k + 2; every result equals the plain AllGather of its input."""
    tm = tt.make_mesh({"tp": N}, device="cpu")
    layer = tt.AllGatherLayer(tm, 3, (16,), dtype=torch.float32, axis="tp",
                              method=comm.AllGatherMethod.RING_BIDIR)
    ws = layer.workspaces
    g = torch.Generator().manual_seed(4)
    xs = [torch.randn((N, 3, 16), generator=g) for _ in range(3)]
    outs = [layer(x) for x in xs[:2]]
    assert outs[0] is ws[0] and outs[1] is ws[1]
    for x, o in zip(xs, outs):
        assert torch.equal(o, comm.all_gather_ref(x, tm, "tp"))
    third = layer(xs[2])
    assert third is ws[0] and torch.equal(third, comm.all_gather_ref(xs[2], tm, "tp"))
    assert torch.equal(outs[1], comm.all_gather_ref(xs[1], tm, "tp"))
    with pytest.raises(ValueError, match="gathers"):
        layer(torch.zeros((N, 2, 16)))


def test_ep_entry_points_refuse_missing_cuda(monkeypatch):
    """Without CUDA and without device="cpu", the EP model, its mesh and
    the engine raise rather than move to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.make_mesh({"tp": N})
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.Qwen3(TCFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.Engine.build(TCFG)
