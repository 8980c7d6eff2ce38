"""Parity of the PyTorch port's Qwen3 model and engine with the JAX package,
on the CPU, at tp = 1.

The JAX model builds its random weights; ``from_jax_params`` carries them
into the port; both then run the same prompt.  f32 with 2 layers, so prefill
and decode logits agree to 1e-3 and greedy tokens exactly.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from triton_distributed_tpu.core.mesh import TP_AXIS, make_mesh
from triton_distributed_tpu.models import Engine as JaxEngine
from triton_distributed_tpu.models import ModelConfig as JaxConfig
from triton_distributed_tpu.models import Qwen3 as JaxQwen3
from triton_distributed_tpu.models.kv_cache import init_cache, init_paged_cache

import triton_distributed_tpu_torch as tt

JCFG = JaxConfig(
    num_layers=2, hidden=64, intermediate=128, num_heads=4, num_kv_heads=2,
    head_dim=32, vocab=128, max_length=64, rope_theta=1e6, rms_eps=1e-6,
    dtype=jnp.float32,
)
TCFG = tt.ModelConfig(**{
    f.name: getattr(JCFG, f.name) for f in dataclasses.fields(JCFG)
    if f.name != "dtype"}, dtype=torch.float32)
TOL = dict(atol=1e-3, rtol=1e-3)
BATCH, PROMPT, STEPS, PAGE = 2, 12, 8, 16


@pytest.fixture(scope="module")
def models():
    mesh = make_mesh({TP_AXIS: 1}, devices=jax.devices()[:1])
    jmodel = JaxQwen3(JCFG, mesh)
    jparams = jmodel.init(jax.random.key(0))
    tparams = tt.from_jax_params(jax.tree.map(np.asarray, jparams), TCFG, "cpu")
    return mesh, jmodel, jparams, tt.Qwen3(TCFG, device="cpu"), tparams


def _prompt(seed=0):
    return np.random.default_rng(seed).integers(
        0, JCFG.vocab, (BATCH, PROMPT)).astype(np.int32)


def test_config_mirrors_jax_fields():
    assert [f.name for f in dataclasses.fields(tt.ModelConfig)] == \
        [f.name for f in dataclasses.fields(JaxConfig)]
    c = tt.QWEN3_8B
    assert (c.hidden, c.intermediate, c.num_layers, c.num_heads,
            c.num_kv_heads, c.head_dim, c.vocab) == \
        (4096, 12288, 36, 32, 8, 128, 151936)
    assert c.dtype == torch.bfloat16 and c.qk_norm


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_prefill_and_decode_logits_match_jax(models, layout):
    mesh, jmodel, jparams, tmodel, tparams = models
    ids = _prompt()
    if layout == "paged":
        jcache = init_paged_cache(mesh, JCFG.num_layers, BATCH,
                                  JCFG.num_kv_heads, JCFG.max_length,
                                  JCFG.head_dim, JCFG.dtype, page_size=PAGE)
        tcache = tt.init_paged_cache(TCFG.num_layers, BATCH, TCFG.num_kv_heads,
                                     TCFG.max_length, TCFG.head_dim,
                                     TCFG.dtype, page_size=PAGE, device="cpu")
    else:
        jcache = init_cache(mesh, JCFG.num_layers, BATCH, JCFG.num_kv_heads,
                            JCFG.max_length, JCFG.head_dim, JCFG.dtype)
        tcache = tt.init_cache(TCFG.num_layers, BATCH, TCFG.num_kv_heads,
                               TCFG.max_length, TCFG.head_dim, TCFG.dtype,
                               device="cpu")
    jlog, jcache = jax.jit(jmodel.prefill)(jparams, jcache, jnp.asarray(ids))
    tlog, tcache = tmodel.prefill(tparams, tcache, torch.from_numpy(ids))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)

    decode = jax.jit(jmodel.decode)
    tok = np.asarray(jnp.argmax(jlog[:, -1], axis=-1)).astype(np.int32)
    for _ in range(STEPS):
        jlog, jcache = decode(jparams, jcache, jnp.asarray(tok))
        tlog, tcache = tmodel.decode(tparams, tcache, torch.from_numpy(tok))
        assert tlog.dtype == torch.float32
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        tok = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_engine_greedy_tokens_match_jax(models, layout):
    _, jmodel, jparams, tmodel, tparams = models
    ids = _prompt(1)
    jeng = JaxEngine(jmodel, jparams, batch=BATCH, cache_layout=layout,
                     page_size=PAGE)
    want = np.asarray(jeng.generate(jnp.asarray(ids), 6))
    teng = tt.Engine(tmodel, tparams, batch=BATCH, cache_layout=layout,
                     page_size=PAGE)
    got = teng.generate(torch.from_numpy(ids), 6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    _, stats = teng.serve(torch.from_numpy(ids), 3)
    assert set(stats) == {"prefill_ms", "decode_ms_per_token",
                          "decode_tokens_per_s"}


def test_engine_refuses_unserved_modes():
    # "persistent" is served: one step of every layer (on the CPU JAX's
    # n = 1 reference step), the same greedy tokens as "psum" here
    ids = torch.zeros((1, 4), dtype=torch.int32)
    pers = tt.Engine.build(TCFG, device="cpu", decode_mode="persistent", cache_layout="paged",
                           page_size=PAGE, generator=torch.Generator().manual_seed(3))
    assert pers.model.decode_mode == "persistent"
    want = tt.Engine(tt.Qwen3(TCFG, device="cpu"), pers.params, batch=1, cache_layout="paged",
                     page_size=PAGE).generate(ids, 3)
    assert torch.equal(pers.generate(ids, 3), want)
    # at tp = 1 the AllReduce modes reduce nothing and serve as "psum" (JAX
    # qwen.py:182-190); tests/test_torch_tp.py serves them at tp = 4
    for mode in ("ar", "gemm_ar"):
        assert tt.Engine.build(TCFG, device="cpu", decode_mode=mode).model.decode_mode == mode
    with pytest.raises(ValueError, match="decode_mode"):
        tt.Qwen3(TCFG, device="cpu", decode_mode="nonesuch")
    with pytest.raises(ValueError, match="kv_dtype"):
        tt.Engine.build(TCFG, device="cpu", kv_dtype="int8")   # contiguous
    with pytest.raises(NotImplementedError, match="moe_strategy"):
        tt.Qwen3(dataclasses.replace(TCFG, num_experts=4, moe_intermediate=32),
                 mesh=tt.make_mesh({"tp": 2}, device="cpu"))
    eng = tt.Engine.build(TCFG, device="cpu", batch=1,
                          generator=torch.Generator().manual_seed(3))
    out = eng.generate(torch.zeros((1, 4), dtype=torch.int32), 3)
    assert out.shape == (1, 3)


def test_sample_token_paths():
    """Greedy is the first maximum; the sampled path draws from the given
    generator (same seed, same tokens) and never leaves the top-p set."""
    logits = torch.tensor([[0.0, 3.0, 3.0, -1.0], [5.0, 1.0, 4.9, 0.0]])
    assert tt.sample_token(logits).tolist() == [1, 0]
    draws = [tt.sample_token(logits, torch.Generator().manual_seed(7),
                             temperature=1.0, top_p=0.5) for _ in range(2)]
    assert torch.equal(draws[0], draws[1]) and draws[0].dtype == torch.int32
    for seed in range(20):
        tok = tt.sample_token(logits, torch.Generator().manual_seed(seed),
                              temperature=0.7, top_p=0.6)
        assert tok[0] in (1, 2) and tok[1] in (0, 2)
