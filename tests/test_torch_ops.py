"""Parity of the PyTorch port's ops with the JAX package, on the CPU.

The same inputs, made from ``np.random.default_rng(seed)``, go through the
JAX function (its Pallas kernels in interpret mode) and the port's
counterpart (the plain PyTorch version, which the wrappers take for CPU
tensors).  f32 throughout, so the tolerance (1e-4) is about summation order,
not rounding.  The CUDA kernels themselves are compared with these plain
versions on the card by ``chip_smoke.py``.
"""

import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from triton_distributed_tpu.layers.norm import rms_norm as jax_rms_norm
from triton_distributed_tpu.models import kv_cache as jax_kv
from triton_distributed_tpu.ops import attention as jax_attn
from triton_distributed_tpu.ops import rope as jax_rope

import triton_distributed_tpu_torch as tt
from triton_distributed_tpu_torch.models import kv_cache as tkv

TOL = dict(atol=1e-4, rtol=1e-4)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return np.asarray(jax.device_get(x))


@pytest.mark.parametrize("causal,hk,soft_cap", [
    (True, 2, 0.0), (False, 2, 0.0), (True, 4, 0.0), (True, 2, 5.0),
])
def test_flash_attention_matches_jax(causal, hk, soft_cap):
    rng = np.random.default_rng(0)
    b, h, s, d = 2, 4, 32, 32
    q, k, v = _rand(rng, b, h, s, d), _rand(rng, b, hk, s, d), _rand(rng, b, hk, s, d)
    want = jax_attn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        soft_cap=soft_cap, block_q=16, block_k=16)
    got = tt.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                             soft_cap=soft_cap)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_decode_attention_matches_jax_ragged():
    """GQA, ragged kv_len with an empty row and a length ending mid-block."""
    rng = np.random.default_rng(1)
    b, h, hk, smax, d = 3, 4, 2, 64, 32
    q = _rand(rng, b, h, d)
    k, v = _rand(rng, b, hk, smax, d), _rand(rng, b, hk, smax, d)
    lens = np.array([0, 37, 64], np.int32)
    want = jax_attn.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        n_split=2, block_k=16)
    got = tt.decode_attention(_t(q), _t(k), _t(v), _t(lens))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    assert not got[0].any()                 # length 0 -> zeros
    # a scalar length serves every row
    want = jax_attn.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 21, n_split=2,
        block_k=16)
    got = tt.decode_attention(_t(q), _t(k), _t(v), 21)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("soft_cap", [0.0, 5.0])
def test_paged_decode_attention_matches_jax(soft_cap):
    """Shuffled block table, an empty row, a mid-page length, and table
    entries past a sequence's pages pointing at page 0."""
    rng = np.random.default_rng(2)
    b, h, hk, d, ps, mp = 3, 4, 2, 32, 16, 4
    p = b * mp
    q = _rand(rng, b, h, d)
    pk, pv = _rand(rng, p, hk, ps, d), _rand(rng, p, hk, ps, d)
    table = rng.permutation(p).astype(np.int32).reshape(b, mp)
    lens = np.array([0, 37, 64], np.int32)
    table[1, 3] = 0                         # past seq 1's 3 pages
    want = jax_attn.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(table),
        jnp.asarray(lens), soft_cap=soft_cap)
    got = tt.paged_decode_attention(_t(q), _t(pk), _t(pv), _t(table),
                                    _t(lens), soft_cap=soft_cap)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    assert not got[0].any()


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(3)
    x, w = _rand(rng, 2, 4, 8, 32), _rand(rng, 32)
    np.testing.assert_allclose(
        tt.rms_norm(_t(x), _t(w), 1e-6).numpy(),
        _np(jax_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)), **TOL)
    # shared positions (prefill) and ragged per-sequence positions (decode)
    for pos in (np.arange(8, dtype=np.int32),
                np.array([0, 5], np.int32)[:, None, None]):
        np.testing.assert_allclose(
            tt.apply_rope_at(_t(x), _t(pos), theta=1e6).numpy(),
            _np(jax_rope.apply_rope_at(jnp.asarray(x), jnp.asarray(pos),
                                       theta=1e6)), **TOL)


def test_cache_writes_match_jax():
    """Contiguous and paged (shuffled table, zero-padded trailing page)
    prefill writes, then a ragged paged token append."""
    rng = np.random.default_rng(4)
    layers, b, hk, d, ps, mp, s = 2, 2, 2, 8, 4, 4, 6
    kn, vn = _rand(rng, b, hk, s, d), _rand(rng, b, hk, s, d)

    c = tkv.init_cache(layers, b, hk, ps * mp, d, torch.float32, device="cpu")
    tkv.write_prefill(c, 1, _t(kn), _t(vn))
    jc = jax_kv.KVCache(k=jnp.zeros(tuple(c.k.shape)), v=jnp.zeros(tuple(c.v.shape)),
                        kv_len=jnp.zeros((), jnp.int32))
    jc = jax_kv.write_prefill(jc, 1, jnp.asarray(kn), jnp.asarray(vn))
    np.testing.assert_array_equal(c.k.numpy(), _np(jc.k))
    np.testing.assert_array_equal(c.v.numpy(), _np(jc.v))

    pc = tkv.init_paged_cache(layers, b, hk, ps * mp, d, torch.float32,
                              page_size=ps, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    pc.k.fill_(7.0)                         # stale bytes the pad must clear
    pc.v.fill_(7.0)
    tkv.write_prefill_paged(pc, 0, _t(kn), _t(vn))
    jpc = jax_kv.PagedKVCache(
        k=jnp.full(tuple(pc.k.shape), 7.0), v=jnp.full(tuple(pc.v.shape), 7.0),
        block_table=jnp.asarray(pc.block_table.numpy()),
        seq_lens=jnp.zeros((b,), jnp.int32))
    jpc = jax_kv.write_prefill_paged(jpc, 0, jnp.asarray(kn), jnp.asarray(vn))
    np.testing.assert_array_equal(pc.k.numpy(), _np(jpc.k))
    np.testing.assert_array_equal(pc.v.numpy(), _np(jpc.v))

    lens = np.array([6, 3], np.int32)
    tkv.with_length(pc, _t(lens))
    jpc = jax_kv.with_length(jpc, jnp.asarray(lens))
    kt, vt = _rand(rng, b, hk, d), _rand(rng, b, hk, d)
    tkv.append_token(pc, 0, _t(kt), _t(vt))
    jpc = jax_kv.append_paged(jpc, 0, jnp.asarray(kt), jnp.asarray(vt))
    np.testing.assert_array_equal(pc.k.numpy(), _np(jpc.k))
    np.testing.assert_array_equal(pc.v.numpy(), _np(jpc.v))


def test_wrappers_refuse_unserved_arguments():
    q = torch.zeros(1, 2, 8, 32)
    k = torch.zeros(1, 2, 8, 32)
    with pytest.raises(NotImplementedError, match="segment_ids"):
        tt.flash_attention(q, k, k, segment_ids=torch.zeros(1, 8, dtype=torch.int32))
    # scales belong to int8 pages, both or neither
    pool = torch.zeros(2, 2, 4, 32)
    table, lens = torch.zeros(1, 2, dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
    with pytest.raises(TypeError, match="int8"):
        tt.paged_decode_attention(torch.zeros(1, 2, 32), pool, pool, table, lens,
                                  k_scale=torch.ones(2, 2), v_scale=torch.ones(2, 2))
    with pytest.raises(ValueError, match="both"):
        tt.paged_decode_attention(torch.zeros(1, 2, 32), pool.to(torch.int8),
                                  pool.to(torch.int8), table, lens,
                                  k_scale=torch.ones(2, 2))
    with pytest.raises(TypeError, match="dtype"):
        tt.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="contiguous"):
        tt.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, k)
    with pytest.raises(ValueError, match="kv_dtype"):
        tkv.init_paged_cache(1, 1, 1, 8, 8, page_size=4, device="cpu",
                             kv_dtype="quarter")
    # the fused MLP ring serves n ranks now; its quantized wire waits for B9
    mesh = tt.make_mesh({"tp": 2}, device="cpu")
    with pytest.raises(NotImplementedError, match="B9"):
        tt.fused_mlp_ar(torch.zeros(1, 8), torch.zeros(2, 8, 16), torch.zeros(2, 8, 16), mesh,
                        wire_dtype="fp8")


def test_port_import_leaves_jax_out():
    code = (
        "import sys, triton_distributed_tpu_torch\n"
        "import triton_distributed_tpu_torch.ops.swizzle\n"
        "import triton_distributed_tpu_torch.ops.matmul\n"
        "import triton_distributed_tpu_torch.tune.autotuner\n"
        "import triton_distributed_tpu_torch.analysis.footprint\n"
        "import triton_distributed_tpu_torch.obs.costs\n"
        "import triton_distributed_tpu_torch.tools.perf_model\n"
        "import triton_distributed_tpu_torch.comm\n"
        "import triton_distributed_tpu_torch.comm.ring\n"
        "import triton_distributed_tpu_torch.core.mesh\n"
        "import triton_distributed_tpu_torch.core.symm\n"
        "import triton_distributed_tpu_torch.lang.primitives\n"
        "import triton_distributed_tpu_torch.tools.calibrate\n"
        "import triton_distributed_tpu_torch.ops.ag_gemm\n"
        "import triton_distributed_tpu_torch.ops.gemm_rs\n"
        "import triton_distributed_tpu_torch.ops.gemm_ar\n"
        "import triton_distributed_tpu_torch.layers.tp_mlp\n"
        "import triton_distributed_tpu_torch.layers.tp_attn\n"
        "import triton_distributed_tpu_torch.models.convert\n"
        "import triton_distributed_tpu_torch.ops.fused_decode\n"
        "import triton_distributed_tpu_torch.ops.persistent_decode\n"
        "import triton_distributed_tpu_torch.comm.all_to_all\n"
        "import triton_distributed_tpu_torch.comm.quantized\n"
        "import triton_distributed_tpu_torch.lang.quant\n"
        "import triton_distributed_tpu_torch.layers.moe\n"
        "import triton_distributed_tpu_torch.layers.allgather_layer\n"
        "import triton_distributed_tpu_torch.ops.moe_utils\n"
        "import triton_distributed_tpu_torch.tools.aot\n"
        "import triton_distributed_tpu_torch.tools.overlap\n"
        "import triton_distributed_tpu_torch.tools.calibrate\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'triton_distributed_tpu'"
        " or m.startswith('triton_distributed_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_refuse_missing_cuda(monkeypatch):
    """With no CUDA and no explicit device, the entry points raise instead
    of moving to the CPU on their own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tt.ModelConfig(num_layers=1, hidden=32, intermediate=64,
                         num_heads=2, num_kv_heads=1, head_dim=16, vocab=32,
                         max_length=16, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.Engine.build(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.Qwen3(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.Qwen3(cfg, device="cuda")
    assert tt.Qwen3(cfg, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.init_attention_state(1, 2, 8, 16)
    assert tt.init_attention_state(1, 2, 8, 16, device="cpu")[2].device.type == "cpu"
    assert tt.device_kind() == "cpu"
    # CPU tensors take the plain versions; the tuner measures nothing
    x = torch.ones(8, 8)
    assert tt.fresh_tune_matmul(x, x) == tt.LibraryBackend()
    assert torch.equal(tt.matmul(x, x, bm=64, bn=64, bk=16), x @ x)
    # the overlap probe and graph capture: CUDA unless the caller asks for
    # the CPU, where precompile records the buckets and serves eagerly
    from triton_distributed_tpu_torch.tools import aot, overlap

    with pytest.raises(RuntimeError, match="CUDA"):
        overlap.overlap_kernels(256, 256, 256)
    assert len(overlap.overlap_kernels(256, 256, 256, device="cpu")) == 3
    with pytest.raises(RuntimeError, match="CUDA"):
        aot.Captured(lambda t: t, [x], None, None)
    eng = tt.Engine.build(cfg, device="cpu")
    assert eng.precompile([8])["buckets"] == [8]
