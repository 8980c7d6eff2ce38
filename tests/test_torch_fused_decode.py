"""Parity of the port's decode megakernel path (``decode_mode="fused"``) with
the JAX package, on the CPU.

``fused_attn_decode`` (the port's plain version, which the wrapper takes for
CPU tensors) against the JAX function (its Pallas kernel in interpret mode),
f32, outputs and pools within 1e-4; then ``Qwen3(decode_mode="fused")`` on a
paged cache against the JAX model: decode logits within 1e-3 over 8 steps,
greedy tokens of the engine and of ``decode_multi`` exactly equal.  The CUDA
kernel itself is held to the plain version on the card by ``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from triton_distributed_tpu.core.mesh import TP_AXIS, make_mesh
from triton_distributed_tpu.layers.tp_attn import TPAttnParams as JaxAttnParams
from triton_distributed_tpu.layers.tp_mlp import TPMLPParams as JaxMLPParams
from triton_distributed_tpu.models import ModelConfig as JaxConfig
from triton_distributed_tpu.models import Qwen3 as JaxQwen3
from triton_distributed_tpu.models.kv_cache import init_paged_cache
from triton_distributed_tpu.models.qwen import QwenLayerParams as JaxLayerParams
from triton_distributed_tpu.models.qwen import QwenParams as JaxParams
from triton_distributed_tpu.ops import fused_decode as jax_fd

import triton_distributed_tpu_torch as tt

TOL = dict(atol=1e-4, rtol=1e-4)
LOGIT_TOL = dict(atol=1e-3, rtol=1e-3)

JCFG = JaxConfig(
    num_layers=2, hidden=64, intermediate=128, num_heads=4, num_kv_heads=2,
    head_dim=32, vocab=128, max_length=32, rope_theta=1e6, rms_eps=1e-6,
    dtype=jnp.float32,
)
TCFG = tt.ModelConfig(**{
    f.name: getattr(JCFG, f.name) for f in dataclasses.fields(JCFG)
    if f.name != "dtype"}, dtype=torch.float32)
BATCH, PROMPT, STEPS, PAGE = 2, 12, 8, 16


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return np.asarray(jax.device_get(x))


def _attn_inputs(seed, g, quantized):
    """b = 3, K = 64, Hkv = 2, D = 32, pages of 8, 4 pages a sequence in a
    shuffled table; the new token at 0, on a page boundary, mid-page."""
    rng = np.random.default_rng(seed)
    b, k_dim, hk, d, ps, mp = 3, 64, 2, 32, 8, 4
    p = b * mp
    x = _rand(rng, b, k_dim)
    wqkv = _rand(rng, k_dim, (hk * g + 2 * hk) * d, scale=k_dim ** -0.5)
    qn, kn = 1 + _rand(rng, d, scale=0.2), 1 + _rand(rng, d, scale=0.2)
    table = rng.permutation(p).astype(np.int32).reshape(b, mp)
    lens = np.array([0, 8, 17], np.int32)
    if quantized:
        pk = rng.integers(-127, 128, (p, hk, ps, d)).astype(np.int8)
        pv = rng.integers(-127, 128, (p, hk, ps, d)).astype(np.int8)
        scales = [(rng.random((p, hk)) * 0.02 + 0.005).astype(np.float32)
                  for _ in range(2)]
    else:
        pk, pv = _rand(rng, p, hk, ps, d), _rand(rng, p, hk, ps, d)
        scales = [None, None]
    return x, wqkv, qn, kn, pk, pv, table, lens, scales


@pytest.mark.parametrize("g,qk_norm,quantized", [
    (1, True, False), (4, False, False), (2, True, True),
])
def test_fused_attn_decode_matches_jax(g, qk_norm, quantized):
    x, wqkv, qn, kn, pk, pv, table, lens, (ks, vs) = _attn_inputs(g, g, quantized)
    eps = 1e-6 if qk_norm else None
    kw = dict(rope_theta=1e6, qk_eps=eps)

    def j(a):
        return None if a is None else jnp.asarray(a)

    want = jax_fd.fused_attn_decode(
        j(x), j(wqkv), j(qn), j(kn), j(pk), j(pv), j(table), j(lens),
        k_scale=j(ks), v_scale=j(vs), **kw)
    tpk, tpv = _t(pk), _t(pv)
    got = tt.fused_attn_decode(
        _t(x), _t(wqkv), _t(qn), _t(kn), tpk, tpv, _t(table), _t(lens),
        k_scale=None if ks is None else _t(ks),
        v_scale=None if vs is None else _t(vs), **kw)
    assert len(got) == len(want) == (5 if quantized else 3)
    np.testing.assert_allclose(got[0].numpy(), _np(want[0]), **TOL)
    if quantized:        # the pools pass through; the token comes back
        np.testing.assert_array_equal(tpk.numpy(), pk)
        np.testing.assert_array_equal(tpv.numpy(), pv)
        np.testing.assert_allclose(got[3].numpy(), _np(want[3]), **TOL)
        np.testing.assert_allclose(got[4].numpy(), _np(want[4]), **TOL)
    else:                # the pools are updated in place, as JAX's aliased pools
        np.testing.assert_allclose(tpk.numpy(), _np(want[1]), **TOL)
        np.testing.assert_allclose(tpv.numpy(), _np(want[2]), **TOL)


def _prompt(seed):
    return np.random.default_rng(seed).integers(
        0, JCFG.vocab, (BATCH, PROMPT)).astype(np.int32)


def jax_greedy_run(jmodel, jparams, prefill, ids, steps, kv_dtype=None):
    """The JAX reference of a served request: ``prefill`` (a jitted prefill)
    of ``ids`` into a paged cache, then ``steps`` jitted greedy decode steps
    of ``jmodel``.  Returns the prefilled cache (numpy), the first token, the
    decode steps' logits and the greedy tokens (first token included)."""
    mesh = jmodel.mesh
    jcache = init_paged_cache(mesh, JCFG.num_layers, BATCH, JCFG.num_kv_heads,
                              JCFG.max_length, JCFG.head_dim, JCFG.dtype,
                              page_size=PAGE, kv_dtype=kv_dtype)
    jlog, jcache = prefill(jparams, jcache, jnp.asarray(ids))
    prefilled = jax.tree.map(np.asarray, jcache)
    decode = jax.jit(jmodel.decode)
    tok = jnp.argmax(jlog[:, -1], axis=-1).astype(jnp.int32)
    first, logits, tokens = np.asarray(tok), [], [np.asarray(tok)]
    for _ in range(steps):
        jlog, jcache = decode(jparams, jcache, tok)
        tok = jnp.argmax(jlog, axis=-1).astype(jnp.int32)
        logits.append(np.asarray(jlog))
        tokens.append(np.asarray(tok))
    return dict(prefilled=prefilled, first=first, logits=logits,
                tokens=np.stack(tokens, axis=1), final=jax.tree.map(np.asarray, jcache))


def check_port_run(tmodel, tparams, run, ids, kv_dtype=None):
    """The port decodes from the JAX prefilled cache with the JAX tokens fed
    (logits within 1e-3 at every step), and its engine serves ``ids`` from an
    empty cache to the same greedy tokens."""
    tcache = tt.from_jax_cache(run["prefilled"], "cpu")
    tok = run["first"]
    for step, want in enumerate(run["logits"]):
        tlog, tcache = tmodel.decode(tparams, tcache, torch.tensor(tok))
        assert tlog.dtype == torch.float32
        np.testing.assert_allclose(tlog.numpy(), want, **LOGIT_TOL)
        tok = run["tokens"][:, step + 1]
    np.testing.assert_array_equal(tcache.seq_lens.numpy(), run["final"].seq_lens)
    teng = tt.Engine(tmodel, tparams, batch=BATCH, cache_layout="paged",
                     page_size=PAGE, kv_dtype=kv_dtype)
    got = teng.generate(torch.from_numpy(ids), run["tokens"].shape[1])
    np.testing.assert_array_equal(got.numpy(), run["tokens"])
    return tcache


def jax_params_of(p: tt.QwenParams) -> JaxParams:
    """The JAX parameter tree holding the port's weights (the layouts are
    the same at tp = 1)."""
    def j(t):
        return None if t is None else jnp.asarray(t.numpy())

    return JaxParams(
        embed=j(p.embed), final_norm=j(p.final_norm), lm_head=j(p.lm_head),
        layers=[JaxLayerParams(
            ln1=j(lp.ln1), ln2=j(lp.ln2),
            attn=JaxAttnParams(wqkv=j(lp.attn.wqkv), wo=j(lp.attn.wo),
                               q_norm=j(lp.attn.q_norm), k_norm=j(lp.attn.k_norm)),
            mlp=JaxMLPParams(gate_up=j(lp.mlp.gate_up), down=j(lp.mlp.down)))
            for lp in p.layers])


@pytest.fixture(scope="session")
def jax_qwen():
    """The JAX models in both decode modes over one set of seeded weights
    (the port's, carried across), and one jitted prefill (prefill does not
    depend on the decode mode)."""
    mesh = make_mesh({TP_AXIS: 1}, devices=jax.devices()[:1])
    jmodels = {m: JaxQwen3(JCFG, mesh, decode_mode=m) for m in ("psum", "fused")}
    tparams = tt.Qwen3(TCFG, device="cpu").init(torch.Generator().manual_seed(0))
    return jmodels, jax_params_of(tparams), jax.jit(jmodels["psum"].prefill), tparams


@pytest.fixture(scope="module")
def fused_run(jax_qwen):
    jmodels, jparams, prefill, tparams = jax_qwen
    ids = _prompt(0)
    run = jax_greedy_run(jmodels["fused"], jparams, prefill, ids, STEPS)
    return (jmodels["fused"], jparams, tt.Qwen3(TCFG, device="cpu", decode_mode="fused"),
            tparams, ids, run)


def test_fused_decode_logits_and_engine_tokens_match_jax(fused_run):
    _, _, tmodel, tparams, ids, run = fused_run
    tcache = check_port_run(tmodel, tparams, run, ids)
    # the pools after 8 fused steps: every appended token in place
    np.testing.assert_allclose(tcache.k.numpy(), run["final"].k, **TOL)
    np.testing.assert_allclose(tcache.v.numpy(), run["final"].v, **TOL)


def test_decode_multi_matches_jax(fused_run):
    jmodel, jparams, tmodel, tparams, _, run = fused_run
    jtoks, jcache = jmodel.decode_multi(
        jparams, jax.tree.map(jnp.asarray, run["prefilled"]),
        jnp.asarray(run["first"]), 4)
    ttoks, tcache = tmodel.decode_multi(
        tparams, tt.from_jax_cache(run["prefilled"], "cpu"),
        torch.tensor(run["first"]), 4)
    assert ttoks.shape == (4, BATCH) and ttoks.dtype == torch.int32
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tcache.seq_lens.numpy(), _np(jcache.seq_lens))


def test_set_decode_mode_keeps_params_and_cache():
    eng = tt.Engine.build(TCFG, device="cpu", batch=1, cache_layout="paged",
                          page_size=PAGE, generator=torch.Generator().manual_seed(3))
    ids = torch.zeros((1, 4), dtype=torch.int32)
    want = eng.generate(ids, 4)
    shared = eng.model
    eng.set_decode_mode("fused")
    assert eng.model.decode_mode == "fused" and shared.decode_mode == "psum"
    np.testing.assert_array_equal(eng.generate(ids, 4).numpy(), want.numpy())
    eng.set_decode_mode("persistent")
    assert eng.model.decode_mode == "persistent"
    np.testing.assert_array_equal(eng.generate(ids, 4).numpy(), want.numpy())
    # on a contiguous cache the fused mode keeps the per-kernel attention
    # (JAX qwen.py:746-749): the same step as psum
    flat = tt.Engine(shared, eng.params, batch=1)
    want = flat.generate(ids, 4)
    flat.set_decode_mode("fused")
    np.testing.assert_array_equal(flat.generate(ids, 4).numpy(), want.numpy())


def test_decode_reductions_follow_the_mode(monkeypatch):
    """The o-proj and MLP of a decode step go through the fused mode's
    GEMM + AllReduce entries in "fused" mode only, on either layout
    (JAX qwen.py:152-190, :695-734); "psum" keeps the plain products."""
    from triton_distributed_tpu_torch.models import qwen as tq

    calls = []
    for name in ("fused_linear_ar", "fused_mlp_ar"):
        real = getattr(tq, name)
        monkeypatch.setattr(tq, name, lambda *a, _f=real, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    ids = torch.zeros((1, 4), dtype=torch.int32)
    for layout in ("contiguous", "paged"):
        eng = tt.Engine.build(TCFG, device="cpu", batch=1, cache_layout=layout,
                              page_size=PAGE, generator=torch.Generator().manual_seed(3))
        eng.generate(ids, 2)
        assert calls == []
        eng.set_decode_mode("fused")
        eng.generate(ids, 2)
        assert calls.count("fused_linear_ar") == calls.count("fused_mlp_ar") \
            == TCFG.num_layers
        calls.clear()


def test_k4_counters_are_kept_per_stream():
    """K4's work and ticket counters: one zeroed buffer per (device,
    stream), shared by launches on that stream and grown when a launch
    needs more; launches on another stream get their own."""
    from triton_distributed_tpu_torch.ops import fused_decode as fd

    cpu = torch.device("cpu")
    try:
        a = fd._sync_buffer(cpu, 11, 8)
        assert a.dtype == torch.int32 and a.numel() == 8 and not a.any()
        assert fd._sync_buffer(cpu, 11, 6) is a
        b = fd._sync_buffer(cpu, 12, 8)
        assert b is not a and not b.any()
        grown = fd._sync_buffer(cpu, 11, 16)
        assert grown.numel() == 16 and fd._sync_buffer(cpu, 11, 8) is grown
        assert fd._sync_buffer(cpu, 12, 8) is b
    finally:
        for stream in (11, 12):
            fd._sync_buffers.pop(("cpu", None, stream), None)
