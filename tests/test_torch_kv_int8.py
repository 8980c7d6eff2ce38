"""Parity of the port's int8 paged KV cache with the JAX package, on the CPU.

The cache functions (``kv_dtype="int8"``: per-(page, head) f32 scales,
requantizing writes) against ``triton_distributed_tpu/models/kv_cache.py``:
codes equal but for one-code differences at rounding ties, scales within
1e-6 relative.  The int8 page form of ``paged_decode_attention`` against the
JAX kernel in interpret mode (1e-4), and ``Qwen3`` on an int8 cache in both
decode modes against the JAX model: decode logits within 1e-3, greedy tokens
exactly equal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_fused_decode import (
    BATCH,
    JCFG,
    TCFG,
    TOL,
    _np,
    _prompt,
    _rand,
    _t,
    check_port_run,
    jax_greedy_run,
    jax_qwen,  # noqa: F401  (a fixture, shared with that module)
)
from triton_distributed_tpu.core.mesh import TP_AXIS, make_mesh
from triton_distributed_tpu.models import Qwen3 as JaxQwen3
from triton_distributed_tpu.models import kv_cache as jax_kv
from triton_distributed_tpu.ops import attention as jax_attn

import triton_distributed_tpu_torch as tt
from triton_distributed_tpu_torch.lang import quant
from triton_distributed_tpu_torch.models import kv_cache as tkv

SCALE_TOL = dict(rtol=1e-6, atol=0.0)
# jitted: one compile each instead of a compile per eager op
jax_write_prefill_paged = jax.jit(jax_kv.write_prefill_paged, static_argnums=1)
jax_append_paged = jax.jit(jax_kv.append_paged, static_argnums=1)


def assert_codes_close(got, want):
    """int8 codes equal, except one-code differences where a value lies on a
    rounding tie (the two sides divide by the scale in a different order)."""
    diff = np.abs(got.astype(np.int32) - np.asarray(want).astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= 0.01


def _jax_copy(c: tkv.PagedKVCache):
    def j(t):
        return None if t is None else jnp.asarray(t.numpy())

    return jax_kv.PagedKVCache(k=j(c.k), v=j(c.v), block_table=j(c.block_table),
                               seq_lens=j(c.seq_lens), k_scale=j(c.k_scale),
                               v_scale=j(c.v_scale))


def assert_caches_match(c: tkv.PagedKVCache, jc):
    for got, want in ((c.k, jc.k), (c.v, jc.v)):
        assert got.dtype == torch.int8
        assert_codes_close(got.numpy(), _np(want))
    for got, want in ((c.k_scale, jc.k_scale), (c.v_scale, jc.v_scale)):
        np.testing.assert_allclose(got.numpy(), _np(want), **SCALE_TOL)


def test_int8_cache_writes_match_jax():
    """Init, a prefill write (a zero-padded trailing page, stale bytes in the
    pool), a ragged append, and the dequantized views."""
    rng = np.random.default_rng(5)
    layers, b, hk, d, ps, mp, s = 2, 2, 2, 8, 4, 4, 6
    mesh = make_mesh({TP_AXIS: 1}, devices=jax.devices()[:1])
    jinit = jax_kv.init_paged_cache(mesh, layers, b, hk, ps * mp, d, jnp.float32,
                                    page_size=ps, kv_dtype="int8")
    c = tkv.init_paged_cache(layers, b, hk, ps * mp, d, torch.float32, page_size=ps,
                             device="cpu", generator=torch.Generator().manual_seed(0),
                             kv_dtype="int8")
    assert c.quantized and c.k.dtype == torch.int8 and c.k_scale.shape == (layers, b * mp, hk)
    np.testing.assert_array_equal(c.k_scale.numpy(), _np(jinit.k_scale))
    c.k.fill_(100)                          # stale codes the writes must replace
    jc = _jax_copy(c)
    kn, vn = _rand(rng, b, hk, s, d), _rand(rng, b, hk, s, d)
    tkv.write_prefill_paged(c, 1, _t(kn), _t(vn))
    jc = jax_write_prefill_paged(jc, 1, jnp.asarray(kn), jnp.asarray(vn))
    assert_caches_match(c, jc)

    lens = np.array([6, 3], np.int32)
    tkv.with_length(c, _t(lens))
    jc = jax_kv.with_length(jc, jnp.asarray(lens))
    kt, vt = _rand(rng, b, hk, d, scale=3.0), _rand(rng, b, hk, d)
    tkv.append_paged(c, 1, _t(kt), _t(vt))
    jc = jax_append_paged(jc, 1, jnp.asarray(kt), jnp.asarray(vt))
    assert_caches_match(c, jc)

    full = tkv.dequantize_pool(c, torch.float32)
    np.testing.assert_allclose(full.k.numpy(), _np(jc.k) * _np(jc.k_scale)[..., None, None],
                               atol=2 * float(c.k_scale.max()), rtol=0)
    k1, v1 = tkv.layer_pool(c, 1, torch.float32)
    torch.testing.assert_close(k1, full.k[1])
    torch.testing.assert_close(v1, full.v[1])


def test_int8_append_ignores_stale_recycled_page_bytes():
    """A recycled page still holds its last tenant's codes and scale: the
    append that starts a new sequence on it must zero the slots past the
    token before it takes the absmax, so the scale is the token's own."""
    rng = np.random.default_rng(6)
    b, hk, d, ps, mp = 2, 2, 8, 4, 2
    c = tkv.init_paged_cache(1, b, hk, ps * mp, d, torch.float32, page_size=ps,
                             device="cpu", kv_dtype="int8")
    c.k.fill_(127)
    c.v.fill_(-127)
    c.k_scale.fill_(50.0)                   # a large stale scale
    c.v_scale.fill_(50.0)
    tkv.with_length(c, torch.tensor([0, 5], dtype=torch.int32))
    jc = _jax_copy(c)
    kt, vt = _rand(rng, b, hk, d), _rand(rng, b, hk, d)
    tkv.append_paged(c, 0, _t(kt), _t(vt))
    jc = jax_append_paged(jc, 0, jnp.asarray(kt), jnp.asarray(vt))
    assert_caches_match(c, jc)
    page = int(c.block_table[0, 0])           # sequence 0 starts a fresh page
    want = np.abs(kt[0]).max(axis=-1) / quant.INT8_MAX + quant.SCALE_EPS
    np.testing.assert_allclose(c.k_scale[0, page].numpy(), want, **SCALE_TOL)
    assert not c.k[0, page, :, 1:].any() and not c.v[0, page, :, 1:].any()


def test_append_paged_raises_when_a_sequence_outgrows_its_table():
    c = tkv.init_paged_cache(1, 2, 1, 8, 4, torch.float32, page_size=4,
                             device="cpu", kv_dtype="int8")
    tkv.with_length(c, torch.tensor([8, 3], dtype=torch.int32))
    tok = torch.zeros(2, 1, 4)
    with pytest.raises(tkv.PagePoolExhausted) as info:
        tkv.append_paged(c, 0, tok, tok)
    assert info.value.sequences == (0,)
    with pytest.raises(jax_kv.PagePoolExhausted):
        jax_kv.append_paged(_jax_copy(c), 0, jnp.zeros((2, 1, 4)), jnp.zeros((2, 1, 4)))


@pytest.mark.parametrize("dtype,kv_dtype", [
    ("bfloat16", None), ("bfloat16", "int8"), ("float32", None), ("float32", "int8"),
])
def test_kv_page_bytes_matches_jax(dtype, kv_dtype):
    got = tt.kv_page_bytes(36, 8, 64, 128, getattr(torch, dtype), kv_dtype)
    assert got == jax_kv.kv_page_bytes(36, 8, 64, 128, getattr(jnp, dtype), kv_dtype)


def test_int8_paged_decode_attention_matches_jax():
    """Shuffled table, an empty row, a mid-page length, table entries past a
    sequence's pages at page 0; int8 codes with random scales."""
    rng = np.random.default_rng(7)
    b, h, hk, d, ps, mp = 3, 4, 2, 32, 16, 4
    p = b * mp
    q = _rand(rng, b, h, d)
    pk = rng.integers(-127, 128, (p, hk, ps, d)).astype(np.int8)
    pv = rng.integers(-127, 128, (p, hk, ps, d)).astype(np.int8)
    ks, vs = [(rng.random((p, hk)) * 0.05 + 0.01).astype(np.float32) for _ in range(2)]
    table = rng.permutation(p).astype(np.int32).reshape(b, mp)
    table[1, 3] = 0
    lens = np.array([0, 37, 64], np.int32)
    want = jax_attn.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(table),
        jnp.asarray(lens), k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    got = tt.paged_decode_attention(_t(q), _t(pk), _t(pv), _t(table), _t(lens),
                                    k_scale=_t(ks), v_scale=_t(vs))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    assert not got[0].any()


@pytest.mark.parametrize("mode", ["psum", "fused"])
def test_int8_decode_logits_and_engine_tokens_match_jax(jax_qwen, mode):
    """psum: the requantizing append, then K3 over int8 pages; fused: K4
    with the token in full precision, then the requantizing append."""
    jmodels, jparams, prefill, tparams = jax_qwen
    ids = _prompt(2)
    run = jax_greedy_run(jmodels[mode], jparams, prefill, ids, 3, kv_dtype="int8")
    tcache = check_port_run(tt.Qwen3(TCFG, device="cpu", decode_mode=mode), tparams,
                            run, ids, kv_dtype="int8")
    assert tcache.quantized
    assert_codes_close(tcache.k.numpy(), run["final"].k)
    np.testing.assert_allclose(tcache.k_scale.numpy(), run["final"].k_scale,
                               rtol=1e-5, atol=0.0)
