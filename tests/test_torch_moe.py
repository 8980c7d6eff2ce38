"""Parity of the PyTorch port's MoE path (Qwen3-MoE at tp = 1) with the JAX
package, on the CPU.

The same numpy-seeded inputs go through the JAX function and its port: the
grouped GEMM's plain version against ``group_gemm`` (``lax.ragged_dot``) and
against the Pallas grouped matmul in interpret mode, the tile schedule, the
routing utilities, the MoE layer, and the whole model (2 layers, 8 experts,
top-2, f32).  The JAX references are jitted and computed once per module.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from triton_distributed_tpu.core.mesh import TP_AXIS, make_mesh
from triton_distributed_tpu.layers.moe import MoEMLP as JaxMoEMLP
from triton_distributed_tpu.models import ModelConfig as JaxConfig
from triton_distributed_tpu.models import Qwen3 as JaxQwen3
from triton_distributed_tpu.models.kv_cache import init_cache, init_paged_cache
from triton_distributed_tpu.ops import moe_utils as jmu
from triton_distributed_tpu.ops.group_gemm import (
    GroupGemmConfig as JaxGroupGemmConfig,
    group_gemm as jax_group_gemm,
    grouped_matmul as jax_grouped_matmul,
)
from triton_distributed_tpu.ops.swizzle import grouped_tile_schedule as jax_schedule

import triton_distributed_tpu_torch as tt
from triton_distributed_tpu_torch.ops import group_gemm as tgg
from triton_distributed_tpu_torch.ops import moe_utils as tmu
from triton_distributed_tpu_torch.core import launches
from triton_distributed_tpu_torch.ops.swizzle import (
    SLOT_FIELDS,
    derived_tile_schedule,
    grouped_tile_schedule,
)

E, TOP_K, HIDDEN, FFN = 8, 2, 64, 32
JCFG = JaxConfig(
    num_layers=2, hidden=HIDDEN, intermediate=128, num_heads=4, num_kv_heads=2,
    head_dim=32, vocab=128, max_length=64, rope_theta=1e6, rms_eps=1e-6,
    dtype=jnp.float32, num_experts=E, top_k=TOP_K, moe_intermediate=FFN,
)
TCFG = tt.ModelConfig(**{
    f.name: getattr(JCFG, f.name) for f in dataclasses.fields(JCFG)
    if f.name != "dtype"}, dtype=torch.float32)
GEMM_TOL = dict(atol=1e-5, rtol=1e-5)     # f32, summation order only
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-3, rtol=1e-3)
BATCH, PROMPT, STEPS, PAGE = 2, 12, 4, 16

# (rows T, splits): empty groups, a zero tail past sum(splits), T not a
# multiple of the tile, everything in one group
SPLIT_CASES = [
    (40, [5, 0, 7, 3, 0, 9, 4, 2]),
    (37, [0, 0, 12, 0, 1, 0, 20, 0]),
    (24, [0, 0, 0, 24, 0, 0, 0, 0]),
]


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh({TP_AXIS: 1}, devices=jax.devices()[:1])


@pytest.mark.parametrize("t,splits", SPLIT_CASES)
def test_grouped_matmul_plain_matches_jax(t, splits):
    rng = _rng(t)
    x = rng.standard_normal((t, 48)).astype(np.float32)
    w = rng.standard_normal((E, 48, 40)).astype(np.float32)
    s = np.asarray(splits, np.int32)
    got = tt.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(s)).numpy()
    want = np.asarray(jax_group_gemm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s)))
    np.testing.assert_allclose(got, want, **GEMM_TOL)
    assert not got[s.sum():].any(), "rows past sum(splits) are not zero"
    if t % 8 == 0:   # the Pallas kernel in interpret mode, 8-row tiles
        pallas = jax_grouped_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                                    config=JaxGroupGemmConfig(8, 16, 16))
        np.testing.assert_allclose(got, np.asarray(pallas), **GEMM_TOL)
    # bf16 operands, f32 result: one f32 accumulation rounded once
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    got32 = tt.grouped_matmul(xb, wb, torch.from_numpy(s), out_dtype=torch.float32)
    want32 = tgg.grouped_matmul_ref(xb.float(), wb.float(), torch.from_numpy(s))
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), want32.numpy(), **GEMM_TOL)


def test_grouped_tile_schedule_matches_jax():
    rng = _rng(1)
    cases = [(s, 40, bm) for t, s in SPLIT_CASES if t == 40 for bm in (4, 8)]
    cases.append((SPLIT_CASES[2][1], 24, 8))
    for t in (32, 40):   # random splits with empty groups and a zero tail
        s = rng.multinomial(int(rng.integers(0, t + 1)), np.ones(E) / E)
        cases.append((list(s * (rng.random(E) > 0.3)), t, 8))
    schedule = jax.jit(jax_schedule, static_argnums=(1, 2))
    for splits, t, bm in cases:
        s = np.asarray(splits, np.int32)
        want = schedule(jnp.asarray(s), t, bm)
        got = grouped_tile_schedule(torch.from_numpy(s), t, bm)
        for name, a, b in zip(want._fields, want, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f"{name} for {splits} T={t} bm={bm}")
        # the form K5's derivation is read back in on the card: padding zeroed
        derived = derived_tile_schedule(torch.from_numpy(s), t, bm)
        valid = np.asarray(want.valid)
        for name in SLOT_FIELDS:
            np.testing.assert_array_equal(derived[name].numpy(),
                                          np.asarray(getattr(want, name)) * valid,
                                          err_msg=f"derived {name} for {splits}")


def test_launch_forms_counted_beside_the_total():
    launches.reset_launch_counts()
    try:
        for form in ((32, 2048, 1536), (32, 768, 2048), (32, 2048, 1536)):
            launches.count("grouped_matmul", form)
        launches.count("flash_attention")
        assert tt.launch_counts()["grouped_matmul"] == 3
        assert tt.launch_forms() == {("grouped_matmul", (32, 2048, 1536)): 2,
                                     ("grouped_matmul", (32, 768, 2048)): 1}
    finally:
        launches.reset_launch_counts()
    assert tt.launch_forms() == {} and not any(tt.launch_counts().values())


def test_routing_matches_jax():
    rng = _rng(2)
    logits = rng.standard_normal((10, E)).astype(np.float32)
    x = rng.standard_normal((10, HIDDEN)).astype(np.float32)
    for renorm in (True, False):
        jid, jw = jmu.topk_route(jnp.asarray(logits), TOP_K, renormalize=renorm)
        tid, tw = tmu.topk_route(torch.from_numpy(logits), TOP_K, renormalize=renorm)
        np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6, rtol=0)
    jxr, jeid, jwf = jmu.flatten_topk(jnp.asarray(x), jid, jw)
    txr, teid, twf = tmu.flatten_topk(torch.from_numpy(x), tid, tw)
    np.testing.assert_array_equal(txr.numpy(), np.asarray(jxr))
    jxs, jsplits, junsort = jmu.sort_by_expert(jxr, jeid, E)
    txs, tsplits, tunsort = tmu.sort_by_expert(txr, teid, E)
    np.testing.assert_array_equal(tsplits.numpy(), np.asarray(jsplits))
    np.testing.assert_array_equal(tunsort.numpy(), np.asarray(junsort))
    np.testing.assert_array_equal(txs.numpy(), np.asarray(jxs))
    assert tsplits.dtype == torch.int32
    y = rng.standard_normal((txs.shape[0], 24)).astype(np.float32)
    want = jmu.unsort_combine(jnp.asarray(y), junsort, jwf, TOP_K)
    got = tmu.unsort_combine(torch.from_numpy(y), tunsort, twf, TOP_K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("path,swiglu", [("forward_tp", True),
                                         ("forward_replicated", True),
                                         ("forward_replicated", False)])
def test_moe_layer_matches_jax(mesh, path, swiglu):
    jlayer = JaxMoEMLP(mesh, num_experts=E, top_k=TOP_K, swiglu=swiglu)
    jp = jlayer.init(jax.random.key(3), HIDDEN, FFN, dtype=jnp.float32)
    tp = tt.MoEParams(*(torch.from_numpy(np.array(a))
                        for a in (jp.router, jp.w_up, jp.w_dn)))
    x = _rng(4).standard_normal((16, HIDDEN)).astype(np.float32)
    want = jax.jit(getattr(jlayer, path))(jp, jnp.asarray(x))
    got = getattr(tt.MoEMLP(num_experts=E, top_k=TOP_K, swiglu=swiglu), path)(
        tp, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (16, HIDDEN)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def _caches(mesh, layout):
    if layout == "paged":
        return (init_paged_cache(mesh, JCFG.num_layers, BATCH, JCFG.num_kv_heads,
                                 JCFG.max_length, JCFG.head_dim, JCFG.dtype,
                                 page_size=PAGE),
                tt.init_paged_cache(TCFG.num_layers, BATCH, TCFG.num_kv_heads,
                                    TCFG.max_length, TCFG.head_dim, TCFG.dtype,
                                    page_size=PAGE, device="cpu"))
    return (init_cache(mesh, JCFG.num_layers, BATCH, JCFG.num_kv_heads,
                       JCFG.max_length, JCFG.head_dim, JCFG.dtype),
            tt.init_cache(TCFG.num_layers, BATCH, TCFG.num_kv_heads,
                          TCFG.max_length, TCFG.head_dim, TCFG.dtype, device="cpu"))


@pytest.fixture(scope="module")
def model(mesh):
    """The JAX MoE model, its weights carried into the port, and the JAX
    psum run (prefill logits, then each decode step's logits, greedy) on
    each cache layout: the reference of both port decode modes."""
    jmodel = JaxQwen3(JCFG, mesh)
    jparams = jmodel.init(jax.random.key(0))
    tparams = tt.from_jax_params(jax.tree.map(np.asarray, jparams), TCFG, "cpu")
    ids = _rng(5).integers(0, JCFG.vocab, (BATCH, PROMPT)).astype(np.int32)
    prefill, decode = jax.jit(jmodel.prefill), jax.jit(jmodel.decode)
    refs = {}
    for layout in ("contiguous", "paged"):
        jcache, _ = _caches(mesh, layout)
        jlog, jcache = prefill(jparams, jcache, jnp.asarray(ids))
        logs = [np.asarray(jlog)]
        tok = np.asarray(jnp.argmax(jlog[:, -1], axis=-1)).astype(np.int32)
        for _ in range(STEPS):
            jlog, jcache = decode(jparams, jcache, jnp.asarray(tok))
            logs.append(np.asarray(jlog))
            tok = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)
        refs[layout] = logs
    return jparams, tparams, ids, refs


@pytest.mark.parametrize("mode", ["psum", "fused"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_qwen_moe_matches_jax(mesh, model, layout, mode):
    _, tparams, ids, refs = model
    tmodel = tt.Qwen3(TCFG, device="cpu", decode_mode=mode)
    _, tcache = _caches(mesh, layout)
    tlog, tcache = tmodel.prefill(tparams, tcache, torch.from_numpy(ids))
    want = refs[layout]
    np.testing.assert_allclose(tlog.numpy(), want[0], **LOGIT_TOL)
    tok = want[0][:, -1].argmax(-1).astype(np.int32)
    for step in range(STEPS):
        tlog, tcache = tmodel.decode(tparams, tcache, torch.from_numpy(tok))
        np.testing.assert_allclose(tlog.numpy(), want[step + 1], **LOGIT_TOL,
                                   err_msg=f"decode step {step}")
        np.testing.assert_array_equal(tlog.argmax(-1).numpy(), want[step + 1].argmax(-1))
        tok = want[step + 1].argmax(-1).astype(np.int32)


def test_from_jax_params_moe_and_config(model):
    jparams, tparams, _, _ = model
    for jl, tl in zip(jparams.layers, tparams.layers):
        assert isinstance(tl.mlp, tt.MoEParams)
        for name in ("router", "w_up", "w_dn"):
            np.testing.assert_array_equal(getattr(tl.mlp, name).numpy(),
                                          np.asarray(getattr(jl.mlp, name)))
    assert tparams.layers[0].mlp.w_up.shape == (E, HIDDEN, 2 * FFN)
    c = tt.QWEN3_30B_A3B
    assert (c.num_layers, c.hidden, c.intermediate, c.num_heads, c.num_kv_heads,
            c.head_dim, c.vocab) == (48, 2048, 6144, 32, 4, 128, 151936)
    assert (c.num_experts, c.top_k, c.moe_intermediate, c.norm_topk,
            c.moe_strategy, c.moe_fp8_wire) == (128, 8, 768, True, "tp", False)
    assert c.is_moe and c.qk_norm and c.dtype == torch.bfloat16
    assert (c.rope_theta, c.rms_eps) == (1e6, 1e-6)


def test_moe_refuses_unserved():
    # the EP strategy is served at any tp (tests/test_torch_ep.py); the TP
    # strategy's collectives at tp > 1 are ROADMAP A7
    m2 = tt.make_mesh({"tp": 2}, device="cpu")
    with pytest.raises(NotImplementedError, match="A7"):
        tt.Qwen3(TCFG, mesh=m2)
    with pytest.raises(NotImplementedError, match="A7"):
        tt.MoEMLP(num_experts=E, mesh=m2).forward_tp(None, torch.zeros((4, HIDDEN)))
    with pytest.raises(ValueError, match="fp8_wire"):
        tt.MoEMLP(num_experts=E, fp8_wire="sometimes")
    with pytest.raises(ValueError, match="divide"):
        tt.MoEMLP(num_experts=E, mesh=tt.make_mesh({"tp": 3}, device="cpu"))
    x, w = torch.zeros((4, 16)), torch.zeros((2, 16, 8))
    with pytest.raises(ValueError, match="splits"):
        tt.grouped_matmul(x, w, torch.tensor([4], dtype=torch.int32))
    with pytest.raises(ValueError, match="inner dims"):
        tt.grouped_matmul(x, torch.zeros((2, 8, 8)), torch.tensor([2, 2], dtype=torch.int32))
    with pytest.raises(TypeError, match="out_dtype"):
        tt.grouped_matmul(x, w, torch.tensor([2, 2], dtype=torch.int32),
                          out_dtype=torch.bfloat16)
