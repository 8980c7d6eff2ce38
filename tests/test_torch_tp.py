"""The port at tp = 4 on co-located ranks (the overlapped GEMMs K12-K14 and
dense Qwen3 on a mesh) against the JAX package, on the CPU.

The JAX Pallas collectives give no result in interpret mode within a test's
time here, so two other surfaces of the JAX package hold the port, as in
``tests/test_torch_comm.py``:

- the protocol recorder (``analysis/record.py::record_kernel`` over
  ``analysis/registry.py``'s ``_ag_gemm_cases``, ``_gemm_rs_cases`` and
  ``_gemm_ar_cases``): every rank's copies, credits, waits and chunk
  products, in order, which the port's schedule mirrors (``comm/ring.py``
  and ``ops/{ag_gemm,gemm_rs,gemm_ar}.py``) must reproduce;
- the XLA references (``resilience/fallbacks.py::xla_ag_gemm``,
  ``xla_gemm_rs``, ``xla_gemm_ar``, ``xla_all_reduce``), which compute the
  same functions with ``lax`` collectives on the virtual CPU mesh.  The
  model test puts them in place of the Pallas ops inside the JAX ``Qwen3``
  (the names ``models/qwen.py`` and ``layers/tp_mlp.py`` import), which
  gives a real JAX Qwen3 at tp = 4 to hold the port's tp = 4 against, on
  the same weights.  No file of the JAX package changes.

The JAX model's three attention kernels are put out of the way the same
way: four ranks running Pallas kernels in interpret mode at once inside a
``shard_map`` deadlock in the interpreter teardown that ``tests/conftest.py``
serializes.  In their place go their goldens in jnp (the kernels'
docstrings: softmax(q k^T scale + mask) v in f32; JAX's own XLA decode,
``ops/attention.py::_xla_decode_fn``, over the cache or the pages gathered
through the block table).  The port's attention kernels are held to the
Pallas ones at tp = 1 by ``tests/test_torch_qwen.py``.

Inputs come from ``np.random.default_rng(seed)`` or the JAX model's own
seeded weights.  The kernels are held to these plain versions on the card
by ``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import triton_distributed_tpu.layers.tp_mlp as jax_tp_mlp
import triton_distributed_tpu.models.qwen as jax_qwen
from triton_distributed_tpu.analysis import record, registry
from triton_distributed_tpu.analysis.events import ComputeEv, CopyEv, NotifyEv, WaitEv
from triton_distributed_tpu.core.mesh import make_mesh as jax_mesh
from triton_distributed_tpu.models import ModelConfig as JaxConfig
from triton_distributed_tpu.models import Qwen3 as JaxQwen3
from triton_distributed_tpu.models.kv_cache import init_cache as jax_init_cache
from triton_distributed_tpu.models.kv_cache import init_paged_cache as jax_init_paged_cache
from triton_distributed_tpu.ops.swizzle import ring_chunk_order as jax_ring_chunk_order
from triton_distributed_tpu.resilience import fallbacks

import triton_distributed_tpu_torch as tt
from triton_distributed_tpu_torch.comm.allreduce import AllReduceMethod
from triton_distributed_tpu_torch.layers.tp_mlp import stack_columns, stack_rows
from triton_distributed_tpu_torch.lang.primitives import (Matmul, Notify, Put, Reduce, Team,
                                                          Wait)
from triton_distributed_tpu_torch.ops import ag_gemm as AG
from triton_distributed_tpu_torch.ops import gemm_ar as AR
from triton_distributed_tpu_torch.ops import gemm_rs as RS
from triton_distributed_tpu_torch.ops.swizzle import bidir_chunk_order, ring_chunk_order

N = 4
JCFG = JaxConfig(
    num_layers=2, hidden=64, intermediate=128, num_heads=8, num_kv_heads=4,
    head_dim=16, vocab=256, max_length=64, rope_theta=1e6, rms_eps=1e-6,
    dtype=jnp.float32,
)
TCFG = tt.ModelConfig(**{
    f.name: getattr(JCFG, f.name) for f in dataclasses.fields(JCFG)
    if f.name != "dtype"}, dtype=torch.float32)
BATCH, PROMPT, NEW, PAGE = 4, 16, 4, 16
# f32 model: the two frameworks sum in other orders (the port's ring adds
# chunk by chunk), ~1e-6 of O(1) logits
TOL = dict(atol=1e-4, rtol=1e-4)
MODES = ("psum", "ar", "gemm_ar")
LAYOUTS = ("contiguous", "paged")


def _np(x):
    return np.asarray(jax.device_get(x)).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dtype)


# ---------------------------------------------------------------------------
# schedules: the JAX recorder's events vs the port's programs

M_LOC = 4   # the registry cases' rows of a chunk
# JAX semaphores -> the port's flags, per body (send and local-copy
# semaphores have no counterpart: a put is made by the block's own stores)
_SEMS = {"ag_gemm": {"recv_sems": "recv", "<collective_barrier>": "barrier"},
         "gemm_rs": {"recv_sems": "rs_recv", "ack_sems": "ack", "ag_recv_sems": "recv",
                     "<collective_barrier>": "barrier"}}
_ARRIVALS = ("recv", "rs_recv")
BODIES = {"ag_gemm/unidir": AG.unidir_program, "ag_gemm/bidir": AG.bidir_program,
          "gemm_rs/ring": RS.ring_program, "gemm_ar/ring": AR.ring_program}


def _jax_events(case, rank):
    """One rank of a JAX body as (puts, notifies, waits, computes), each
    with its step (the arrival waits before it).  A put is (step, buffer,
    chunk or slot, destination rank); a compute (step, "matmul", the A chunk
    it reads) or (step, "reduce", the output chunk the last add writes)."""
    _, thunk = case.make(rank)
    rec = record.record_kernel(thunk, n=case.n, rank=rank)
    sems = _SEMS["ag_gemm" if case.name.startswith("ag_gemm") else "gemm_rs"]
    puts, notes, waits, comps, step = [], [], [], [], 0
    for ev in rec.events:
        if isinstance(ev, CopyEv):
            d = ev.dst
            if d.buffer in ("ag", "out"):
                puts.append((step, d.buffer, d.bounds[0][0] // M_LOC, ev.dst_rank))
            else:   # recv_buf: (slot, rows, cols)
                puts.append((step, "recv", d.bounds[0][0], ev.dst_rank))
        elif isinstance(ev, ComputeEv):
            if ev.kind == "matmul":
                comps.append((step, "matmul", ev.reads[0].bounds[0][0] // M_LOC))
            elif ev.write.buffer == "out":   # the last add; the others are fused into puts
                comps.append((step, "reduce", ev.write.bounds[0][0] // M_LOC))
        elif isinstance(ev, NotifyEv):
            name, idx = ev.sem
            notes.append((step, sems[name], idx or 0, ev.target))
        elif isinstance(ev, WaitEv):
            name, idx = ev.sem
            if name not in sems:
                continue
            flag = sems[name]
            waits.append((step, flag, idx or 0, ev.amount if ev.unit == "count" else 1))
            if flag in _ARRIVALS:
                step += 1
    return puts, notes, waits, comps


def _port_events(program, n, rank):
    puts, notes, waits, comps, step = [], [], [], [], 0
    for op in program(Team((("tp", n),), "tp"), rank):
        if isinstance(op, Put):
            puts.append((step, op.dst, op.index, op.dst_rank))
        elif isinstance(op, Matmul):
            comps.append((step, "matmul", op.src[1]))
        elif isinstance(op, Reduce):
            comps.append((step, "reduce", op.dst[1]))
        elif isinstance(op, Notify):
            notes.append((step, op.flag[0], op.flag[1], op.target))
        elif isinstance(op, Wait):
            waits.append((step, op.flag[0], op.flag[1], op.count))
            if op.flag[0] in _ARRIVALS:
                step += 1
    return puts, notes, waits, comps


@pytest.mark.parametrize("n", (2, 3, 4))
def test_overlap_schedules_equal_jax_recorder(n):
    """Every rank of the four bodies (AG-GEMM one-way and two-way, GEMM-RS,
    GEMM-AR): the same puts, ACK and barrier credits, waits (the GEMM-RS
    ACK drain for n = 2, 3 and >= 4 among them) and chunk products, each at
    the same step, as JAX records them.  GEMM-RS's products come before the
    arrival wait of their step, AG-GEMM's after each forward."""
    cases = {c.name: c for c in registry._ag_gemm_cases(n) + registry._gemm_rs_cases(n)
             + registry._gemm_ar_cases(n)}
    assert set(cases) == set(BODIES)
    for name, program in BODIES.items():
        for rank in range(n):
            want = _jax_events(cases[name], rank)
            got = _port_events(program, n, rank)
            for what, w, g in zip(("puts", "notifies", "waits", "computes"), want, got):
                assert g == w, f"{name} n={n} rank {rank}: {what} differ"
    # every chunk is multiplied once, the AG-GEMM in the ring orders (JAX's
    # ring_chunk_order for the one-way ring), the ACK drains are there to compare
    for name, program in BODIES.items():
        for me in range(n):
            order = [c for _, k, c in _port_events(program, n, me)[3] if k == "matmul"]
            assert sorted(order) == list(range(n)), name
            if name == "ag_gemm/unidir":
                assert order == [ring_chunk_order(me, n, s) for s in range(n)]
                assert order == [int(jax_ring_chunk_order(me, n, s)) for s in range(n)]
            elif name == "ag_gemm/bidir":
                assert order == [bidir_chunk_order(me, n, s) for s in range(n)]
    assert any(f == "ack" for _, f, *_ in _port_events(RS.ring_program, n, 0)[2])


# ---------------------------------------------------------------------------
# the ops' plain versions vs the XLA references


def _meshes(n):
    return jax_mesh({"tp": n}, devices=jax.devices()[:n]), tt.make_mesh({"tp": n}, device="cpu")


def _operands(rng, n, m, k, cols):
    """Unit-variance A (m, k) and B (k, cols) of variance 1 / k."""
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal((k, cols)) / np.sqrt(k)).astype(np.float32)
    return a, b


def _ring_limits(a, b, n, hops=True):
    """(limit, rank 0's partial) of the port's GEMM-RS/AR against the XLA
    reference, per element of the (M, N) sum, for f32 operands a (M, K), b
    (K, N) holding bf16 values.  Both sides sum each partial's length-K/n
    dot and the n partials in f32 in their own orders (each within
    (K/n + n) 2**-24 S of the exact sum, S the sum over the partials of
    |A_r| @ |B_r|); the port then rounds each partial product and the
    partial sum after each ring hop to bf16, the XLA reference its total
    once: 2**-8 of each value rounded (the factor 1 + 2**-5 holds the
    second order).  The ring is ``comm/ring.py::rs_ring_phase``'s: chunk c's
    sum starts at rank c + 1 and travels right.  ``hops`` False: GEMM-AR's
    one-shot form, which rounds each partial and then the f32 sum of the n
    of them once, with no hop between."""
    m, k = a.shape
    kl, ml = k // n, m // n
    parts = np.stack([a[:, r * kl:(r + 1) * kl] @ b[r * kl:(r + 1) * kl] for r in range(n)])
    s = sum(np.abs(a[:, r * kl:(r + 1) * kl]) @ np.abs(b[r * kl:(r + 1) * kl])
            for r in range(n))
    values = np.abs(parts).sum(0) + np.abs(parts.sum(0))
    for c in range(n if hops else 0):
        rows = slice(c * ml, (c + 1) * ml)
        acc = parts[(c + 1) % n, rows]
        for i in range(2, n + 1):
            acc = acc + parts[(c + i) % n, rows]
            values[rows] += np.abs(acc)
    return 2 * (kl + n) * 2.0 ** -24 * s + 2.0 ** -8 * (1 + 2.0 ** -5) * values, parts[0]


@pytest.mark.parametrize("n, method", [
    *[pytest.param(n, None, id=str(n)) for n in (2, 3, 4)],
    *[pytest.param(n, m, id=f"{n}-{AR.FORM_NAMES[m]}") for n in (2, 3, 4)
      for m in (AllReduceMethod.ONE_SHOT, AllReduceMethod.TWO_SHOT)]])
def test_overlap_ops_match_xla(n, method):
    """ag_gemm (both rings, and the gathered A), gemm_rs and gemm_ar on CPU
    tensors, through shard/unshard, against xla_ag_gemm / xla_gemm_rs /
    xla_gemm_ar on the same inputs.  f32 within 1e-5.  bf16 within the
    limit of each rounding at the size of the value rounded: for AG-GEMM
    2 K 2**-24 |A| @ |B| + 2**-7 (1 + 2**-5) |C| (one product, rounded on
    both sides), for GEMM-RS/AR :func:`_ring_limits`.  A result with rank
    0's partial left out must fail that limit by 10x at its worst
    element.  ``method`` None: gemm_ar as a caller gets it (the one-shot at
    these sizes); else the given form forced through the private entry
    (``ops/gemm_ar.py::_gemm_ar``), held to its own limit (the ring's hops,
    or none), with the planted fault for gemm_ar too."""
    rng = np.random.default_rng(30 + n)
    jm, tm = _meshes(n)
    m, k, cols = 8 * n, 16 * n, 8 * n
    for dt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        a, b = _operands(rng, n, m, k, cols)
        if tdt == torch.bfloat16:
            a, b = _np(jnp.asarray(a).astype(dt)), _np(jnp.asarray(b).astype(dt))

        def close(got, want, lim):
            got = got.float().numpy()
            if tdt == torch.float32:
                np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
            else:
                assert np.all(np.abs(got - want) <= lim), np.abs(got - want).max()

        # AllGather-GEMM: A row shards, B column shards
        want = _np(fallbacks.xla_ag_gemm(jnp.asarray(a, dt), jnp.asarray(b, dt), jm, "tp"))
        lim_ag = (2 * k * 2.0 ** -24 * (np.abs(a) @ np.abs(b))
                  + 2.0 ** -7 * (1 + 2.0 ** -5) * np.abs(a @ b))
        a_t, b_t = tt.shard(tm, _t(a, tdt)), stack_columns(_t(b, tdt), n)
        for bidir in (False, True):
            c, gathered = tt.ag_gemm(a_t, b_t, tm, return_gathered=True, bidir=bidir)
            assert c.shape == (n, m, cols // n) and c.dtype == tdt
            for r in range(n):
                np.testing.assert_array_equal(gathered[r].float().numpy(), a)
                sl = slice(r * cols // n, (r + 1) * cols // n)
                close(c[r], want[:, sl], lim_ag[:, sl])
        # GEMM-RS and GEMM-AR: A column shards, B row shards
        a_t, b_t = stack_columns(_t(a, tdt), n), stack_rows(_t(b, tdt), n)
        lim, part0 = _ring_limits(a, b, n)
        want = _np(fallbacks.xla_gemm_rs(jnp.asarray(a, dt), jnp.asarray(b, dt), jm, "tp"))
        out = tt.unshard(tm, tt.gemm_rs(a_t, b_t, tm))
        assert out.shape == (m, cols) and out.dtype == tdt
        close(out, want, lim)
        if tdt == torch.bfloat16:
            assert np.max(np.abs(out.float().numpy() - part0 - want) / lim) >= 10
        want = _np(fallbacks.xla_gemm_ar(jnp.asarray(a, dt), jnp.asarray(b, dt), jm, "tp"))
        if method is None:
            out = tt.gemm_ar(a_t, b_t, tm)
        else:
            out = AR._gemm_ar(a_t, b_t, tm, "tp", tdt, method)
            lim, _ = _ring_limits(a, b, n, hops=method == AllReduceMethod.TWO_SHOT)
        assert out.shape == (n, m, cols) and out.dtype == tdt
        for r in range(n):
            close(out[r], want, lim)
            if method is not None and tdt == torch.bfloat16:
                assert np.max(np.abs(out[r].float().numpy() - part0 - want) / lim) >= 10


def test_overlap_ops_refuse_and_degenerate():
    """n == 1 is a plain product; the quantized wire, a tuple axis, K or N
    not a multiple of 8, a dtype pair not built, a config other than None
    and M not divisible by n raise."""
    one = tt.make_mesh({"tp": 1}, device="cpu")
    a, b = torch.randn(1, 6, 8), torch.randn(1, 8, 16)
    torch.testing.assert_close(tt.ag_gemm(a, b, one), a @ b)
    torch.testing.assert_close(tt.gemm_rs(a, b, one), a @ b)
    torch.testing.assert_close(tt.gemm_ar(a, b, one), a @ b)
    tm = tt.make_mesh({"tp": 2}, device="cpu")
    a, b = torch.randn(2, 4, 16), torch.randn(2, 16, 8)
    with pytest.raises(NotImplementedError, match="B9"):
        tt.ag_gemm(a, b, tm, wire_dtype="int8")
    with pytest.raises(NotImplementedError, match="hierarchical"):
        tt.gemm_rs(a, b, tm, ("tp", "tp"))
    with pytest.raises(ValueError, match="multiples of 8"):
        tt.ag_gemm(a[..., :12], b[:, :12], tm)
    with pytest.raises(TypeError, match="overlapped GEMMs take"):
        tt.gemm_ar(a.double(), b.double(), tm)
    with pytest.raises(NotImplementedError, match="config=None"):
        tt.gemm_rs(a, b, tm, config=(64, 64, 64))
    with pytest.raises(ValueError, match="divisible"):
        tt.gemm_ar(a[:, :3], b, tm)


# ---------------------------------------------------------------------------
# the model: the port's tp = 4 against the JAX Qwen3 at tp = 4


def _flash_golden(q, k, v, *, causal=True, sm_scale=None, **_):
    """softmax(q k^T scale + causal mask) v in f32, GQA, q (B, H, S, D)."""
    group = q.shape[1] // k.shape[1]
    k, v = jnp.repeat(k, group, axis=1), jnp.repeat(v, group, axis=1)
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    sc = jnp.einsum("bhqd,bhkd->bhqk", q.astype(jnp.float32), k.astype(jnp.float32)) * scale
    if causal:
        s_q, s_k = q.shape[2], k.shape[2]
        mask = jnp.arange(s_q)[:, None] + (s_k - s_q) >= jnp.arange(s_k)[None, :]
        sc = jnp.where(mask, sc, -jnp.inf)
    p = jax.nn.softmax(sc, axis=-1)
    return jnp.einsum("bhqk,bhkd->bhqd", p, v.astype(jnp.float32)).astype(q.dtype)


def _decode_golden(q, k, v, kv_len, **_):
    from triton_distributed_tpu.ops.attention import _xla_decode_fn

    b, h, d = q.shape
    fn = _xla_decode_fn(b, h, k.shape[1], k.shape[2], d, d ** -0.5, 0.0, jnp.dtype(q.dtype))
    return fn(q, k, v, kv_len)


def _paged_golden(q, pool_k, pool_v, block_table, seq_lens, **_):
    def gather(pool):   # (P, Hkv, ps, D) -> (B, Hkv, max_pages * ps, D)
        g = pool[block_table]
        return g.transpose(0, 2, 1, 3, 4).reshape(g.shape[0], g.shape[2], -1, g.shape[-1])

    return _decode_golden(q, gather(pool_k), gather(pool_v), seq_lens)


def _patched_ops():
    """The XLA references and attention goldens under the names the JAX
    model's modules import."""
    def ag(a, b, mesh, axis="tp", *, out_dtype=None, **_):
        return fallbacks.xla_ag_gemm(a, b, mesh, axis, out_dtype)

    def rs(a, b, mesh, axis="tp", *, out_dtype=None, **_):
        return fallbacks.xla_gemm_rs(a, b, mesh, axis, out_dtype)

    def gar(a, b, mesh, axis="tp", *, out_dtype=None, **_):
        return fallbacks.xla_gemm_ar(a, b, mesh, axis, out_dtype)

    def allr(x, mesh, axis="tp", *, out_dtype=None, **_):
        return fallbacks.xla_all_reduce(x, mesh, axis, out_dtype)

    return {"ag_gemm": ag, "gemm_rs": rs, "gemm_ar": gar, "all_reduce": allr,
            "flash_attention": _flash_golden, "decode_attention": _decode_golden,
            "paged_decode_attention": _paged_golden}


def _prompt():
    return np.random.default_rng(5).integers(0, JCFG.vocab, (BATCH, PROMPT)).astype(np.int32)


def _jax_caches(mesh):
    return {"contiguous": jax_init_cache(mesh, JCFG.num_layers, BATCH, JCFG.num_kv_heads,
                                         JCFG.max_length, JCFG.head_dim, JCFG.dtype),
            "paged": jax_init_paged_cache(mesh, JCFG.num_layers, BATCH, JCFG.num_kv_heads,
                                          JCFG.max_length, JCFG.head_dim, JCFG.dtype,
                                          page_size=PAGE)}


@pytest.fixture(scope="module")
def jax_tp():
    """The JAX Qwen3 at tp = 4 on the virtual CPU mesh, its Pallas ops
    replaced by the XLA references: prefill logits and caches in both
    layouts; NEW - 1 greedy "psum" decode steps on the contiguous cache;
    the first step of "ar" and "gemm_ar" (contiguous) and of "psum"
    (paged)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_qwen, jax_tp_mlp):
            for name, fn in _patched_ops().items():
                if hasattr(mod, name):
                    mp.setattr(mod, name, fn)
        mesh = jax_mesh({"tp": N}, devices=jax.devices()[:N])
        models = {mode: JaxQwen3(JCFG, mesh, decode_mode=mode) for mode in MODES}
        params = models["psum"].init(jax.random.key(0))
        ids = jnp.asarray(_prompt())
        out = {"params": jax.tree.map(np.asarray, params), "ids": np.array(ids)}
        prefill = jax.jit(models["psum"].prefill)
        for layout, cache in _jax_caches(mesh).items():
            logits, cache = prefill(params, cache, ids)
            out[layout] = {"prefill": _np(logits), "cache": jax.tree.map(np.asarray, cache),
                           "steps": {}}
            tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
            todo = (("psum", NEW - 1), ("ar", 1), ("gemm_ar", 1)) if layout == "contiguous" \
                else (("psum", 1),)
            for mode, steps in todo:
                decode, c, t, logs = jax.jit(models[mode].decode), cache, tok, []
                for _ in range(steps):
                    lg, c = decode(params, c, t)
                    logs.append(_np(lg))
                    t = jnp.argmax(lg, axis=-1).astype(jnp.int32)
                out[layout]["steps"][mode] = logs
            out[layout]["first_token"] = np.asarray(tok)
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
def test_prefill_logits_and_cache_match_jax(jax_tp, port_tp, layout):
    """Prefill at tp = 4 (AG-GEMM, the ranks' attention in one rank-folded
    batch, GEMM-RS): logits within 1e-4 of JAX's, and the head-sharded
    cache, unsharded, within 1e-4 of JAX's cache (the same pages, the same
    table and lengths on every rank)."""
    mesh, params = port_tp
    model = tt.Qwen3(TCFG, mesh=mesh)
    logits, cache = model.prefill(params, _port_cache(layout, N), torch.from_numpy(jax_tp["ids"]))
    np.testing.assert_allclose(logits.numpy(), jax_tp[layout]["prefill"], **TOL)
    glob, want = tt.unshard_cache(cache, N), jax_tp[layout]["cache"]
    np.testing.assert_allclose(glob.k.numpy(), _np(want.k), **TOL)
    np.testing.assert_allclose(glob.v.numpy(), _np(want.v), **TOL)
    if layout == "paged":
        assert cache.block_table.shape[0] == N * BATCH and cache.seq_lens.tolist() == [PROMPT] * (
            N * BATCH)
        np.testing.assert_array_equal(glob.block_table.numpy(), np.asarray(want.block_table))
        # the same state carried in from JAX's cache folds to the port's layout
        carried = tt.from_jax_cache(want, mesh=mesh)
        assert torch.equal(carried.block_table, cache.block_table)
        np.testing.assert_allclose(carried.k.numpy(), cache.k.numpy(), **TOL)
    else:
        assert cache.kv_len == PROMPT


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mode", MODES)
def test_decode_modes_match_jax(jax_tp, port_tp, layout, mode):
    """Every served mode on both caches: the port's greedy tokens (its own
    argmax fed back) equal JAX's "psum" run, and every step's logits are
    within 1e-4 of JAX's (the first step also of JAX's own run in the mode,
    where the JAX run has one); generate() gives the same tokens."""
    mesh, params = port_tp
    ref = jax_tp[layout]
    model = tt.Qwen3(TCFG, mesh=mesh, decode_mode=mode)
    logits, cache = model.prefill(params, _port_cache(layout, N), torch.from_numpy(jax_tp["ids"]))
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    np.testing.assert_array_equal(tok.numpy(), ref["first_token"])
    want_steps = jax_tp["contiguous"]["steps"]["psum"]
    for i, want in enumerate(want_steps):
        lg, cache = model.decode(params, cache, tok)
        np.testing.assert_allclose(lg.numpy(), want, **TOL)
        if i == 0 and mode in ref["steps"]:
            np.testing.assert_allclose(lg.numpy(), ref["steps"][mode][0], **TOL)
        tok = lg.argmax(-1).to(torch.int32)
        np.testing.assert_array_equal(tok.numpy(), want.argmax(-1))
    eng = tt.Engine(model, params, batch=BATCH, cache_layout=layout, page_size=PAGE)
    got = eng.generate(torch.from_numpy(jax_tp["ids"]), NEW)
    want_tokens = [ref["first_token"]] + [w.argmax(-1) for w in want_steps]
    np.testing.assert_array_equal(got.numpy(), np.stack(want_tokens, axis=1))


def _reblocked(params, n_from, n_to):
    """The JAX tree with ``wqkv`` and ``gate_up`` re-fused from n_from to
    n_to rank blocks (numpy arrays)."""
    c = JCFG
    qkv = [c.num_heads * c.head_dim, c.num_kv_heads * c.head_dim, c.num_kv_heads * c.head_dim]

    def rb(a, parts):
        return tt.reblock(torch.from_numpy(np.array(a)), parts, n_from, n_to).numpy()

    layers = [dataclasses.replace(
        lp, attn=dataclasses.replace(lp.attn, wqkv=rb(lp.attn.wqkv, qkv)),
        mlp=dataclasses.replace(lp.mlp, gate_up=rb(lp.mlp.gate_up, [c.intermediate] * 2)))
        for lp in params.layers]
    return dataclasses.replace(params, layers=layers)


def test_tp4_matches_tp1_on_reblocked_weights(jax_tp, port_tp):
    """The JAX tp = 4 weights re-fused to tp = 1 ([q | k | v], [gate | up]):
    the JAX model at tp = 1 and the port at tp = 1 on them give the port's
    tp = 4 prefill logits within 1e-4, and the ports' greedy tokens are equal
    at both tp sizes.  Without re-fusing, the tp = 1 model gets other heads
    of the same shapes, and its logits are far off."""
    mesh, params4 = port_tp
    ids = torch.from_numpy(jax_tp["ids"])
    p1 = _reblocked(jax_tp["params"], N, 1)
    jm1 = jax_mesh({"tp": 1}, devices=jax.devices()[:1])
    jlog, _ = jax.jit(JaxQwen3(JCFG, jm1).prefill)(
        jax.tree.map(jnp.asarray, p1), _jax_caches(jm1)["contiguous"], jnp.asarray(ids.numpy()))
    tparams1 = tt.from_jax_params(p1, TCFG, "cpu")
    m1, m4 = tt.Qwen3(TCFG, device="cpu"), tt.Qwen3(TCFG, mesh=mesh)
    log1, _ = m1.prefill(tparams1, _port_cache("contiguous", 1), ids)
    log4, _ = m4.prefill(params4, _port_cache("contiguous", N), ids)
    np.testing.assert_allclose(log1.numpy(), _np(jlog), **TOL)
    np.testing.assert_allclose(log4.numpy(), log1.numpy(), **TOL)
    for layout in LAYOUTS:
        t1 = tt.Engine(m1, tparams1, batch=BATCH, cache_layout=layout, page_size=PAGE)
        t4 = tt.Engine(m4, params4, batch=BATCH, cache_layout=layout, page_size=PAGE)
        assert torch.equal(t1.generate(ids, NEW), t4.generate(ids, NEW))
    # the trap: tp = 4 columns read as tp = 1 columns
    wrong = tt.from_jax_params(jax_tp["params"], TCFG, "cpu")
    bad, _ = m1.prefill(wrong, _port_cache("contiguous", 1), ids)
    assert np.abs(bad.numpy() - log1.numpy()).max() > 100 * TOL["atol"]
    # and the port's own tp = 4 init shards the tp = 1 draw of the same seed
    g1 = tt.Qwen3(TCFG, device="cpu").init(torch.Generator().manual_seed(9))
    g4 = tt.Qwen3(TCFG, mesh=mesh).init(torch.Generator().manual_seed(9))
    lw = g1.layers[0]
    parts = [TCFG.num_heads * TCFG.head_dim] + [TCFG.num_kv_heads * TCFG.head_dim] * 2
    assert torch.equal(stack_columns(tt.reblock(lw.attn.wqkv, parts, 1, N), N),
                       g4.layers[0].attn.wqkv)
    assert torch.equal(stack_rows(lw.mlp.down, N), g4.layers[0].mlp.down)
    assert g4.embed.data_ptr() != 0 and g4.embed.shape == g1.embed.shape


def test_gemm_ar_mode_takes_ar_path_for_ragged_batch(port_tp):
    """In "gemm_ar" a batch that does not divide by tp runs the "ar" path,
    as JAX does (``qwen.py:164-165``): the same logits as "ar"."""
    mesh, params = port_tp
    ids = torch.from_numpy(_prompt()[:3])
    outs = {}
    for mode in ("ar", "gemm_ar"):
        model = tt.Qwen3(TCFG, mesh=mesh, decode_mode=mode)
        cache = tt.init_cache(TCFG.num_layers, 3, TCFG.num_kv_heads, TCFG.max_length,
                              TCFG.head_dim, TCFG.dtype, device="cpu", tp=N)
        logits, cache = model.prefill(params, cache, ids[:, :PROMPT - 4])   # 3 x 12 rows
        outs[mode] = model.decode(params, cache, logits[:, -1].argmax(-1).to(torch.int32))[0]
    torch.testing.assert_close(outs["gemm_ar"], outs["ar"], atol=0, rtol=0)


def test_tp_refusals(monkeypatch):
    """What is not served at tp > 1 raises by name ("fused" and
    "persistent" are served: tests/test_torch_persistent.py holds them to
    JAX); a mesh on CUDA without CUDA raises; at tp = 1 "ar" and "gemm_ar"
    reduce nothing and serve as "psum", as in JAX."""
    mesh = tt.make_mesh({"tp": N}, device="cpu")
    for mode in ("fused", "persistent"):
        assert tt.Qwen3(TCFG, mesh=mesh, decode_mode=mode).decode_mode == mode
    with pytest.raises(NotImplementedError, match="int8"):
        tt.Engine.build(TCFG, mesh=mesh, cache_layout="paged", kv_dtype="int8")
    with pytest.raises(NotImplementedError, match="MoE"):
        tt.Qwen3(dataclasses.replace(TCFG, num_experts=4, moe_intermediate=32), mesh=mesh)
    with pytest.raises(ValueError, match="divide"):
        tt.Qwen3(dataclasses.replace(TCFG, num_kv_heads=2, num_heads=6), mesh=mesh)
    with pytest.raises(NotImplementedError, match="one axis"):
        tt.Qwen3(TCFG, mesh=tt.make_mesh({"dp": 2, "tp": 4}, device="cpu"))
    eng = tt.Engine.build(TCFG, mesh=mesh, batch=2, generator=torch.Generator().manual_seed(1))
    eng.set_decode_mode("gemm_ar")
    assert eng.model.mesh is mesh and eng.model.tp == N
    ids = torch.zeros((2, 4), dtype=torch.int32)
    base = tt.Engine.build(TCFG, device="cpu", batch=2,
                           generator=torch.Generator().manual_seed(1))
    for mode in ("ar", "gemm_ar"):
        base.set_decode_mode(mode)
        assert base.generate(ids, 3).shape == (2, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.make_mesh({"tp": N})
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.Qwen3(TCFG, mesh=mesh, device="cuda")
