"""The port's state-carrying attention passes (K7, K8 plain versions)
against the JAX package, on the CPU.

The same numpy-seeded inputs go through the JAX function (its Pallas
kernel in interpret mode) and the port's counterpart (its plain version,
taken because the tensors lie on the CPU), state by state: num, m and l of
every split or page, and (m, l, acc) after every chunk of a fold.  f32 is
held to 1e-4 (summation order), bf16 to 1e-2 (p rounded to bf16 at maxima
that differ in the last f32 bit).  Empty splits and pages, and rows that see
no key of a chunk, must give exactly the JAX state: num = acc = 0,
m = -1e30, l = 0.  The kernels themselves run on the card
(``chip_smoke.py``).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from triton_distributed_tpu.ops import attention as jax_attn

import triton_distributed_tpu_torch as tt

TOL = dict(atol=1e-4, rtol=1e-4)
NEG_INF = -1e30


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(jnp.asarray(w, jnp.float32)), **tol)


@pytest.mark.parametrize("n_split,group,soft_cap", [
    (1, 1, 0.0), (2, 4, 0.0), (4, 1, 5.0), (4, 4, 5.0)])
def test_decode_state_matches_jax_per_split(n_split, group, soft_cap):
    """Ragged lengths with an empty row, a length inside the first split
    (the later splits empty) and a full row."""
    rng = np.random.default_rng(10 + n_split + group)
    b, hk, s, d = 3, 2, 64, 32
    h = hk * group
    q, k, v = _rand(rng, b, h, d), _rand(rng, b, hk, s, d), _rand(rng, b, hk, s, d)
    lens = np.array([0, 11, 64], np.int32)
    want = jax_attn.decode_attention_state(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        n_split=n_split, soft_cap=soft_cap, block_k=8)
    got = tt.decode_attention_state(_t(q), _t(k), _t(v), _t(lens),
                                    n_split=n_split, soft_cap=soft_cap,
                                    block_k=8)
    assert [tuple(x.shape) for x in got] == [tuple(x.shape) for x in want]
    _close(got, want)
    num, m, l = got
    sp = s // n_split
    for row, n in enumerate(lens):
        empty = np.arange(n_split) * sp >= n
        assert not num[row][:, empty].any() and not l[row][:, empty].any()
        assert (m[row][:, empty] == NEG_INF).all()
    if n_split == 4:   # the default
        assert tt.auto_n_split(s) == 4
        _close(tt.decode_attention_state(_t(q), _t(k), _t(v), _t(lens),
                                         soft_cap=soft_cap), want)


def test_decode_state_merge_associative():
    """Merged split states, normalized, equal one split and the port's
    decode_attention (JAX test_decode_state_merge_associative), with an
    empty row held at zero."""
    rng = np.random.default_rng(20)
    b, h, hk, s, d = 2, 4, 2, 256, 64
    q, k, v = _rand(rng, b, h, d), _rand(rng, b, hk, s, d), _rand(rng, b, hk, s, d)
    lens = _t(np.array([0, 200], np.int32))
    num4, m4, l4 = tt.decode_attention_state(_t(q), _t(k), _t(v), lens, n_split=4)
    num, m, l = tt.merge_decode_states(num4, m4, l4)
    out = num[..., 0, :] / l[..., 0][..., None].clamp_min(1e-38)
    one = tt.decode_attention_state(_t(q), _t(k), _t(v), lens, n_split=1)
    np.testing.assert_allclose(out[1].numpy(), (one[0][1, :, 0] / one[2][1, :, :1]).numpy(),
                               atol=2e-5, rtol=2e-5)
    want = tt.decode_attention(_t(q), _t(k), _t(v), lens)
    np.testing.assert_allclose(out[1].numpy(), want[1].numpy(), atol=2e-5, rtol=2e-5)
    assert not out[0].any() and not want[0].any()
    # merging in two groupings (pairs of splits, then the pairs) agrees
    a = tt.merge_decode_states(num4[..., :2, :], m4[..., :2], l4[..., :2])
    c = tt.merge_decode_states(num4[..., 2:, :], m4[..., 2:], l4[..., 2:])
    nested = tt.merge_decode_states(torch.cat([a[0], c[0]], -2),
                                    torch.cat([a[1], c[1]], -1),
                                    torch.cat([a[2], c[2]], -1))
    for x, y in zip(nested, (num, m, l)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_paged_decode_state_matches_jax_per_page(kind):
    """Shuffled table, an empty row, a mid-page length and table entries
    past a sequence's pages; one state per logical page."""
    rng = np.random.default_rng(30)
    b, h, hk, d, ps, mp = 3, 4, 2, 32, 16, 4
    p = b * mp
    q = _rand(rng, b, h, d)
    table = rng.permutation(p).astype(np.int32).reshape(b, mp)
    table[1, 3] = 0
    lens = np.array([0, 37, 64], np.int32)
    kw, tkw = {}, {}
    if kind == "int8":
        pk = rng.integers(-127, 128, (p, hk, ps, d)).astype(np.int8)
        pv = rng.integers(-127, 128, (p, hk, ps, d)).astype(np.int8)
        ks = (rng.random((p, hk)) * 0.02 + 0.001).astype(np.float32)
        vs = (rng.random((p, hk)) * 0.02 + 0.001).astype(np.float32)
        kw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        tkw = dict(k_scale=_t(ks), v_scale=_t(vs))
        jq, tq, tol = jnp.asarray(q), _t(q), TOL
    else:
        pk, pv = _rand(rng, p, hk, ps, d), _rand(rng, p, hk, ps, d)
        jq = jnp.asarray(q, jnp.bfloat16)
        tq = _t(q).to(torch.bfloat16)
        pk = np.asarray(jnp.asarray(pk, jnp.bfloat16).astype(jnp.float32))
        pv = np.asarray(jnp.asarray(pv, jnp.bfloat16).astype(jnp.float32))
        tol = dict(atol=1e-2, rtol=1e-2)
    jpk, jpv = jnp.asarray(pk), jnp.asarray(pv)
    tpk, tpv = _t(pk), _t(pv)
    if kind == "bf16":
        jpk, jpv = jpk.astype(jnp.bfloat16), jpv.astype(jnp.bfloat16)
        tpk, tpv = tpk.to(torch.bfloat16), tpv.to(torch.bfloat16)
    want = jax_attn.paged_decode_attention_state(
        jq, jpk, jpv, jnp.asarray(table), jnp.asarray(lens), soft_cap=5.0, **kw)
    got = tt.paged_decode_attention_state(tq, tpk, tpv, _t(table), _t(lens),
                                          soft_cap=5.0, **tkw)
    assert [tuple(x.shape) for x in got] == [(b, h, mp, d), (b, h, mp), (b, h, mp)]
    _close(got, want, tol)
    num, m, l = got
    assert not num[0].any() and not l[0].any() and (m[0] == NEG_INF).all()
    assert (m[1][:, 3] == NEG_INF).all() and not l[1][:, 3].any()


def _chunk_inputs(rng, dtype=np.float32):
    b, h, hk, sq, d = 1, 4, 2, 32, 32
    q = _rand(rng, b, h, sq, d)
    k, v = _rand(rng, b, hk, 80, d), _rand(rng, b, hk, 80, d)
    return q, k, v


@pytest.mark.parametrize("dtype,soft_cap", [("f32", 0.0), ("f32", 5.0), ("bf16", 0.0)])
def test_chunk_fold_matches_jax_state_by_state(dtype, soft_cap):
    """Queries at positions 32..63 fold five 16-key chunks, out of order:
    kv 48 (rows 0-15 see no key: their fresh state must stay exactly as it
    was), kv 64 (wholly in the future: the state passes through), then 0,
    16 and 32.  Offsets are ints and 0-d int32 tensors."""
    rng = np.random.default_rng(40)
    q, k, v = _chunk_inputs(rng)
    b, h, sq, d = q.shape
    jdt, tdt_ = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    tq, tk, tv = (_t(x).to(tdt_) for x in (q, k, v))
    tol = TOL if dtype == "f32" else dict(atol=1e-2, rtol=1e-2)
    jstate = jax_attn.init_attention_state(b, h, sq, d)
    tstate = tt.init_attention_state(b, h, sq, d, device="cpu")
    _close(tstate, jstate, dict(atol=0, rtol=0))
    sm = 0.3
    for step, kv0 in enumerate((48, 64, 0, 16, 32)):
        sl = slice(kv0, kv0 + 16)
        jstate = jax_attn.flash_attention_chunk(
            jq, jk[:, :, sl], jv[:, :, sl], jstate, 32, kv0, sm_scale=sm,
            soft_cap=soft_cap, block_q=16, block_k=16)
        q_off = torch.tensor(32, dtype=torch.int32) if step % 2 else 32
        before = tstate
        tstate = tt.flash_attention_chunk(
            tq, tk[:, :, sl].contiguous(), tv[:, :, sl].contiguous(), tstate,
            q_off, kv0, sm_scale=sm, soft_cap=soft_cap)
        _close(tstate, jstate, tol)
        if kv0 == 48:    # rows 0-15 saw no key: the fresh state, exactly
            assert (tstate[0][:, :, :16] == NEG_INF).all()
            assert not tstate[1][:, :, :16].any() and not tstate[2][:, :, :16].any()
        if kv0 == 64:    # wholly in the future: unchanged
            for x, y in zip(tstate, before):
                assert torch.equal(x, y)
    out = tt.finalize_attention_state(tstate, tdt_)
    want = jax_attn.finalize_attention_state(jstate, jdt)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("group", [1, 2])
def test_chunk_fold_equals_flash_attention(group):
    """Four chunks folded from a fresh state and finalized equal the port's
    flash_attention over the whole sequence (JAX
    test_chunk_state_equals_full_attention, 2e-5), and the last query rows
    alone (the last rank of a 4-way ring) equal its last rows."""
    rng = np.random.default_rng(50 + group)
    b, hk, s, d, c = 1, 2, 128, 64, 4
    h = hk * group
    q, k, v = _rand(rng, b, h, s, d), _rand(rng, b, hk, s, d), _rand(rng, b, hk, s, d)
    tq, tk, tv = _t(q), _t(k), _t(v)
    sc = s // c
    full = tt.flash_attention(tq, tk, tv, causal=True)
    for q0 in (0, s - sc):
        qq = tq[:, :, q0:].contiguous()
        state = tt.init_attention_state(b, h, s - q0, d, device="cpu")
        for j in range(c):
            state = tt.flash_attention_chunk(
                qq, tk[:, :, j * sc:(j + 1) * sc].contiguous(),
                tv[:, :, j * sc:(j + 1) * sc].contiguous(), state,
                q_offset=q0, kv_offset=j * sc, causal=True)
        got = tt.finalize_attention_state(state, tq.dtype)
        np.testing.assert_allclose(got.numpy(), full[:, :, q0:].numpy(),
                                   atol=2e-5, rtol=2e-5)
    want = jax_attn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=True, block_q=64, block_k=64)
    np.testing.assert_allclose(full.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_chunk_refusals():
    q = torch.zeros(1, 2, 8, 32)
    kv = torch.zeros(1, 2, 8, 32)
    state = tt.init_attention_state(1, 2, 8, 32, device="cpu")
    with pytest.raises(NotImplementedError, match="segment_ids"):
        tt.flash_attention_chunk(q, kv, kv, state, 0, 0,
                                 segment_ids_q=torch.zeros(1, 8, dtype=torch.int32),
                                 segment_ids_kv=torch.zeros(1, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="state"):
        tt.flash_attention_chunk(q, kv, kv, (state[0][:, :1], state[1], state[2]), 0, 0)
    with pytest.raises(ValueError, match="not divisible"):
        tt.decode_attention_state(torch.zeros(1, 2, 32), kv, kv, 8, n_split=3)
