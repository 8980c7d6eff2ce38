"""The port's measured infrastructure of tutorial 14 against the JAX package,
on the CPU: the overlap probe's plain versions (K19's) against JAX's Pallas
probe kernels in interpret mode, the probe's persistent tile walk, and the
link calibration's derivations (thresholds, method choice, agreement,
persistence) against JAX's."""

import json

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from triton_distributed_tpu.comm import allgather as jax_ag
from triton_distributed_tpu.comm import allreduce as jax_ar
from triton_distributed_tpu.tools import calibrate as jax_cal
from triton_distributed_tpu.tools import overlap as jax_overlap

from triton_distributed_tpu_torch.comm import allgather as t_ag
from triton_distributed_tpu_torch.comm import allreduce as t_ar
from triton_distributed_tpu_torch.ops.matmul import tile_walk
from triton_distributed_tpu_torch.tools import calibrate as t_cal
from triton_distributed_tpu_torch.tools import overlap as t_overlap

# f32 sums in another order than XLA's: the fused and mxu products of depth
# <= 512 and the dma touch of 2048 terms agree within a few f32 roundings of
# the terms' magnitude
PROBE_TOL = dict(atol=2e-3, rtol=1e-5)


@pytest.mark.parametrize("m,n,k", [(256, 256, 256), (384, 256, 512)])
def test_probe_plain_versions_match_jax(m, n, k):
    rng = np.random.default_rng(m + k)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    jax_fns = jax_overlap.overlap_kernels(m, n, k, bm=128, bn=128, bk=128, dtype=jnp.float32)
    t_fns = t_overlap.overlap_kernels(m, n, k, bm=128, bn=128, bk=128, dtype=torch.float32,
                                      device="cpu")
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for mode, jf, tf in zip(t_overlap.MODES, jax_fns, t_fns):
        want = np.asarray(jf(jnp.asarray(a), jnp.asarray(b)))
        got = tf(ta, tb)
        assert got.shape == (m, n) and got.dtype == torch.float32, mode
        np.testing.assert_allclose(got.numpy(), want, err_msg=mode, **PROBE_TOL)
    # the fused probe is the product; the dma probe is no product
    np.testing.assert_allclose(t_fns[0](ta, tb).numpy(), a @ b, atol=2e-3, rtol=1e-5)
    assert not np.allclose(t_fns[1](ta, tb).numpy(), a @ b, atol=1.0)


def _grouped_order(tiles_m: int, tiles_n: int) -> list[tuple[int, int]]:
    """Groups of 8 m-tiles, each walked down its n-columns (K6's order)."""
    return [(tm, tn) for g in range(-(-tiles_m // 8)) for tn in range(tiles_n)
            for tm in range(8 * g, min(8 * g + 8, tiles_m))]


@pytest.mark.parametrize("blocks", [132, 7, 1000])
@pytest.mark.parametrize("m,n", [(1000, 1000), (4096, 4096)])
@pytest.mark.parametrize("tile", t_overlap.BUILT_TILES[torch.bfloat16])
def test_probe_walk_takes_each_tile_once_in_grouped_order(tile, m, n, blocks):
    """K19's bf16 modes walk the (bm, bn) tiles as K6 does
    (``ops/matmul.py::tile_walk`` mirrors ``probe_wgmma`` too): one
    persistent block an SM (132 on an H100; fewer and more blocks than tiles
    too), block b taking tiles b, b + blocks, ... of the grouped order, every
    tile of both built tiles exactly once, off the tile (1000) and on it
    (4096)."""
    tiles_m, tiles_n = -(-m // tile[0]), -(-n // tile[1])
    walk = tile_walk(m, n, tile, blocks)
    order = _grouped_order(tiles_m, tiles_n)
    assert len(walk) == blocks
    assert sorted(t for share in walk for t in share) == sorted(
        (tm, tn) for tm in range(tiles_m) for tn in range(tiles_n))
    for b, share in enumerate(walk):
        assert share == order[b::blocks]


def test_probe_refusals_and_hidden_pct():
    with pytest.raises(ValueError, match="built for"):
        t_overlap.overlap_kernels(256, 256, 256, bm=1024, bn=1024, bk=512, device="cpu")
    fused, _, _ = t_overlap.overlap_kernels(256, 256, 256, device="cpu")
    assert fused.args[2] == t_overlap.DEFAULT_TILES[torch.bfloat16]
    with pytest.raises(ValueError, match="built for"):
        fused(torch.ones(256, 128, dtype=torch.bfloat16), torch.ones(128, 256, dtype=torch.bfloat16))
    # JAX's endpoints (tests/test_tools.py)
    for args in ((1.25, 0.5, 1.0), (1.0, 0.6, 1.0), (1.6, 0.6, 1.0), (2.0, 0.6, 1.0),
                 (0.9, 0.6, 1.0), (1.0, 0.0, 1.0)):
        assert t_overlap.hidden_pct(*args) == jax_overlap.hidden_pct(*args)
    assert t_overlap.hidden_pct(1.25, 0.5, 1.0) == 0.5


@pytest.fixture
def linkcal(tmp_path, monkeypatch):
    """Both packages' calibration at one throwaway path (they read the same
    variable and the same JSON), their caches dropped before and after."""
    monkeypatch.setenv("TDT_LINKCAL_CACHE", str(tmp_path / "linkcal.json"))
    jax_cal.invalidate_cache()
    t_cal.invalidate_cache()
    yield tmp_path / "linkcal.json"
    jax_cal.invalidate_cache()
    t_cal.invalidate_cache()


CALS = [None, dict(ici_gbps=186.0, ici_hop_us=10.0), dict(ici_gbps=450.0, ici_hop_us=0.0),
        dict(ici_gbps=300.0, ici_hop_us=2.5, dcn_gbps=25.0, dcn_hop_us=8.0),
        dict(ici_gbps=None, ici_hop_us=3.0)]
SIZES = [1, 8192, 200_000, 256 * 1024, 256 * 1024 + 1, 1 << 20, 2_000_000, 1 << 24]


@pytest.mark.parametrize("cal", CALS)
def test_thresholds_and_method_choice_match_jax(linkcal, cal):
    if cal is not None:
        jax_cal.save_calibration(jax_cal.LinkCalibration(device_kind="test", n_devices=4, **cal))
        t_cal.invalidate_cache()
        assert t_cal.load_calibration() == t_cal.LinkCalibration(
            device_kind="test", n_devices=4, **cal)
    assert t_cal.push_bytes_threshold() == jax_cal.push_bytes_threshold()
    assert t_cal.one_shot_bytes_threshold() == jax_cal.one_shot_bytes_threshold()
    for n in (2, 4, 8):
        for s in SIZES:
            assert t_ag.choose_method(s, n).name == jax_ag.choose_method(s, n).name, (s, n)
            assert t_ar.choose_method(s, n).name == jax_ar.choose_method(s, n).name, (s, n)
    if cal is not None and cal.get("dcn_gbps"):
        for h in (1024, 2048, 7168):
            for rate in (50.0, 100.0, 1000.0):
                for wire in ("ici", "dcn"):
                    assert t_cal.codec_pays(wire, h, codec_gbps=rate) == \
                        jax_cal.codec_pays(wire, h, codec_gbps=rate), (wire, h, rate)


def test_tutorial_flip_and_round_trip(linkcal):
    """Tutorial 14's part 2: a measured 10 us hop moves a 1 MiB shard's
    gather to the push; the file round-trips and invalidates."""
    probe = 1 << 20
    assert t_ag.choose_method(probe, 8) == t_ag.AllGatherMethod.RING_BIDIR
    cal = t_cal.LinkCalibration(ici_gbps=186.0, ici_hop_us=10.0, device_kind="tutorial",
                                n_devices=8)
    t_cal.save_calibration(cal)
    assert t_ag.choose_method(probe, 8) == t_ag.AllGatherMethod.PUSH_1SHOT
    assert t_cal.push_bytes_threshold() == 1_860_000
    assert json.loads(linkcal.read_text())["ici_hop_us"] == 10.0
    t_cal.invalidate_cache()
    assert t_cal.load_calibration() == cal
    linkcal.write_text(json.dumps({**cal.to_json(), "ici_hop_us": 0.5, "future_field": 1}))
    assert t_cal.push_bytes_threshold() == 1_860_000      # memoized until invalidated
    t_cal.invalidate_cache()
    assert t_cal.push_bytes_threshold() == 93_000
    linkcal.write_text("not json")
    t_cal.invalidate_cache()
    assert t_cal.load_calibration() is None
    assert t_cal.push_bytes_threshold() == t_cal.DEFAULT_PUSH_BYTES
    with pytest.raises(NotImplementedError, match="A11"):
        t_cal.calibrate()


def test_fit_and_agreement_match_jax():
    sizes = [64 * 1024, 512 * 1024, 2 << 20, 8 << 20]
    times = [2e-6 + s / 150e9 for s in sizes]
    np.testing.assert_allclose(t_cal.fit_latency_bandwidth(sizes, times),
                               jax_cal.fit_latency_bandwidth(sizes, times), rtol=1e-9)
    for bad in (([1], [1.0]), ([1, 2], [2.0, 1.0])):
        with pytest.raises(ValueError):
            t_cal.fit_latency_bandwidth(*bad)
    for vals in ([300_000.0, 600_000.0, 9e10, 3.6e11], [300_000.0, 600_000.0, 1e11, 3.6e11]):
        def mean_fn(_, vals=vals):
            return vals
        assert t_cal.agree_thresholds(1.0, 2.0, n_proc=2, mean_fn=mean_fn) == \
            jax_cal.agree_thresholds(1.0, 2.0, n_proc=2, mean_fn=mean_fn)
    assert t_cal.agree_thresholds(1234.4, 5678.9, n_proc=1) == (1234, 5678)
