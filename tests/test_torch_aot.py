"""Bucketed precompiled serving of the port (``Engine.precompile``) against
the JAX engine's bucketed AOT serving, on the CPU.

The config of JAX's ``tests/test_engine_aot.py`` (2 layers, hidden 128,
f32); the JAX engine at tp = 1 builds its weights, ``from_jax_params``
carries them into the port.  On an engine the caller put on the CPU,
``precompile`` records the buckets and each prompt runs the padded step
eagerly: right-padded to its bucket, the cache length set to the true
length on the device, the logits at ``true_len - 1`` gathered.  Greedy
tokens exact, logits within 1e-5 (f32, two layers).  On the card the same
dispatch replays CUDA graphs (``chip_smoke.py`` phase ``aot_serving``).
"""

import dataclasses
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from triton_distributed_tpu.core.mesh import TP_AXIS, make_mesh
from triton_distributed_tpu.models import Engine as JaxEngine
from triton_distributed_tpu.models import ModelConfig as JaxConfig
from triton_distributed_tpu.models import engine as jax_engine_mod

import triton_distributed_tpu_torch as tt
from triton_distributed_tpu_torch.models import engine as t_engine_mod

JCFG = JaxConfig(num_layers=2, hidden=128, intermediate=256, num_heads=8, num_kv_heads=8,
                 head_dim=16, vocab=256, max_length=64, dtype=jnp.float32)
TCFG = tt.ModelConfig(**{f.name: getattr(JCFG, f.name) for f in dataclasses.fields(JCFG)
                         if f.name != "dtype"}, dtype=torch.float32)
BATCH, BUCKETS, GEN = 2, [16, 32], 5
LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)


def _ids(seed: int, length: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, JCFG.vocab, (BATCH, length)).astype(np.int32)


@pytest.fixture(scope="module")
def engines():
    mesh = make_mesh({TP_AXIS: 1}, devices=jax.devices()[:1])
    jeng = JaxEngine.build(JCFG, mesh, key=jax.random.key(3), batch=BATCH)
    tparams = tt.from_jax_params(jax.tree.map(np.asarray, jeng.params), TCFG, "cpu")
    teng = tt.Engine(tt.Qwen3(TCFG, device="cpu"), tparams, batch=BATCH)
    return jeng, teng


def _port_engine(params=None, **kw):
    if params is None:
        return tt.Engine.build(TCFG, device="cpu", batch=kw.pop("batch", BATCH),
                               generator=torch.Generator().manual_seed(3), **kw)
    return tt.Engine(tt.Qwen3(TCFG, device="cpu"), params, batch=kw.pop("batch", BATCH), **kw)


def test_bucketed_generate_matches_jax(engines):
    jeng, teng = engines
    eager = {n: teng.generate(torch.from_numpy(_ids(n, n)), GEN) for n in (8, 16)}
    jeng.precompile(BUCKETS)
    manifest = teng.precompile(BUCKETS)
    assert manifest["buckets"] == BUCKETS and manifest["cache_layout"] == "contiguous"
    for n in (8, 16, 9):      # 8 pads to 16, 16 fits, 9 pads to 16
        ids = _ids(n, n)
        want_log = np.asarray(jeng.prefill(jnp.asarray(ids)))
        got_log = teng.prefill(torch.from_numpy(ids))
        assert got_log.shape == (BATCH, JCFG.vocab) and got_log.dtype == torch.float32
        np.testing.assert_allclose(got_log.numpy(), want_log, **LOGIT_TOL)
        assert teng.cache.kv_len.dim() == 0 and int(teng.cache.kv_len) == n
        want = np.asarray(jeng.generate(jnp.asarray(ids), GEN))
        got = teng.generate(torch.from_numpy(ids), GEN)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"prompt {n}")
        if n in eager:
            assert torch.equal(got, eager[n])


def test_bucketed_tp4_matches_tp1():
    """The port at tp = 4 on a CPU mesh serves the buckets as at tp = 1:
    the same draw, the padded prefill over four ranks' plain collectives."""
    one = _port_engine()
    four = tt.Engine.build(TCFG, mesh=tt.make_mesh({"tp": 4}, device="cpu"), batch=BATCH,
                           generator=torch.Generator().manual_seed(3))
    for eng in (one, four):
        eng.precompile(BUCKETS)
    for n in (9, 16):
        ids = torch.from_numpy(_ids(100 + n, n))
        np.testing.assert_allclose(four.prefill(ids).numpy(), one.prefill(ids).numpy(),
                                   **LOGIT_TOL)
        assert int(four.cache.kv_len) == n
        assert torch.equal(four.generate(ids, 4), one.generate(ids, 4))


def test_true_len_prefill_then_decode():
    """``prefill(true_len=)`` leaves a 0-d int32 length equal to true_len;
    the next decode equals the decode after an unpadded prefill."""
    eng = _port_engine()
    model, params = eng.model, eng.params
    ids = torch.from_numpy(_ids(7, 11))
    padded = torch.nn.functional.pad(ids, (0, 5))
    tok = torch.tensor([3, 200], dtype=torch.int32)
    outs = []
    for x, true_len in ((ids, None), (padded, torch.tensor(11, dtype=torch.int32)),
                        (padded, 11)):
        cache = tt.init_cache(TCFG.num_layers, BATCH, TCFG.num_kv_heads, TCFG.max_length,
                              TCFG.head_dim, TCFG.dtype, device="cpu")
        logits, cache = model.prefill(params, cache, x, true_len)
        assert cache.kv_len.shape == () and cache.kv_len.dtype == torch.int32
        assert int(cache.kv_len) == 11
        step, cache = model.decode(params, cache, tok)
        assert int(cache.kv_len) == 12
        outs.append((logits[:, 10], step))
    for last, step in outs[1:]:
        np.testing.assert_allclose(last.numpy(), outs[0][0].numpy(), **LOGIT_TOL)
        np.testing.assert_allclose(step.numpy(), outs[0][1].numpy(), **LOGIT_TOL)


def test_prompt_longer_than_buckets_serves_eagerly():
    eng = _port_engine()
    ids = torch.from_numpy(_ids(3, 20))
    want = eng.generate(ids, 3)
    eng.precompile([8])
    assert eng._bucket(20) is None and eng._bucket(5) == 8
    assert torch.equal(eng.generate(ids, 3), want)


def test_precompile_validates(tmp_path):
    eng = _port_engine()
    with pytest.raises(ValueError, match="max_length"):
        eng.precompile([4096])
    with pytest.raises(ValueError, match="buckets"):
        eng.precompile([])
    with pytest.raises(ValueError, match="contiguous"):
        _port_engine(cache_layout="paged", page_size=16).precompile([16])
    moe = tt.Engine.build(dataclasses.replace(TCFG, num_experts=4, top_k=2, moe_intermediate=64),
                          device="cpu", batch=BATCH)
    with pytest.raises(NotImplementedError, match="MoE"):
        moe.precompile([16])
    # the batch check reads the manifest before capturing anything
    (tmp_path / "aot_manifest.json").write_text(json.dumps(
        {"buckets": [16], "batch": 2, "max_length": 64, "vocab": 256, "decode_mode": "psum",
         "cache_layout": "contiguous"}))
    with pytest.raises(ValueError, match="batch"):
        _port_engine(batch=3).load_precompiled(str(tmp_path))
    # set_decode_mode drops the graphs (and here the buckets)
    eng.precompile([16])
    eng.set_decode_mode("fused")
    assert eng._bucket(10) is None


def test_save_dir_round_trip(tmp_path):
    eng = _port_engine()
    manifest = eng.precompile([16, 32], save_dir=str(tmp_path))
    assert json.loads((tmp_path / "aot_manifest.json").read_text()) == manifest
    ids = torch.from_numpy(_ids(2, 12))
    want = eng.generate(ids, 4)
    other = _port_engine(eng.params)
    assert other.load_precompiled(str(tmp_path)) == manifest
    assert other._bucket(12) == 16
    assert torch.equal(other.generate(ids, 4), want)
    # a manifest of another architecture is refused, the field named
    bigger = dataclasses.replace(TCFG, num_heads=4, hidden=256)
    wrong = tt.Engine(tt.Qwen3(bigger, device="cpu"), None, batch=BATCH)
    with pytest.raises(ValueError, match="num_heads"):
        wrong.load_precompiled(str(tmp_path))


def test_arch_fingerprint_matches_jax():
    """The fingerprint is JAX's, field for field, and a mismatch names every
    differing field (JAX's ``test_arch_fingerprint_rejects_different_model``)."""
    mesh = make_mesh({TP_AXIS: 1}, devices=jax.devices()[:1])
    want = jax_engine_mod.arch_fingerprint(JCFG, mesh, TP_AXIS)
    fp = t_engine_mod.arch_fingerprint(TCFG, None, TP_AXIS)
    assert json.loads(json.dumps(fp)) == json.loads(json.dumps(want))
    t_engine_mod.check_arch({"arch": fp}, fp)
    t_engine_mod.check_arch({}, fp)
    other = t_engine_mod.arch_fingerprint(dataclasses.replace(TCFG, num_heads=4, hidden=256),
                                          None, TP_AXIS)
    for field in ("num_heads", "hidden"):
        with pytest.raises(ValueError, match=field):
            t_engine_mod.check_arch({"arch": fp}, other)
    with pytest.raises(ValueError, match="mesh"):
        t_engine_mod.check_arch({"arch": fp}, dict(fp, mesh={"tp": 2}))
    four = tt.make_mesh({"tp": 4}, device="cpu")
    assert t_engine_mod.arch_fingerprint(TCFG, four)["mesh"] == {"tp": 4}
