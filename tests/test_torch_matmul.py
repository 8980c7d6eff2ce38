"""The port's matmul (K6's plain version and the library backend) and its
autotuner, against the JAX package, on the CPU.

The same numpy-seeded operands go through JAX ``ops.matmul`` (the Pallas
kernel in interpret mode for explicit tiles, ``XlaBackend()`` for the
library) and the port's ``matmul`` (its plain version, taken because the
tensors lie on the CPU).  f32 agrees within 1e-5 (summation order only);
bf16 results within one bf16 ulp of the f32 product of the same bf16
operands (each side rounds an f32 sum once).  The tuner tests mirror
``tests/test_autotuner.py`` with the port's rule for failures: only
``TileInfeasible`` is skipped.  Each test points ``TDT_AUTOTUNE_CACHE`` at
its own ``tmp_path``.  K6 itself runs on the card (``chip_smoke.py``).
"""

import json
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from triton_distributed_tpu.ops.matmul import matmul as jax_matmul
from triton_distributed_tpu.tune.autotuner import XlaBackend

import triton_distributed_tpu_torch as tt
from triton_distributed_tpu_torch.analysis import footprint
from triton_distributed_tpu_torch.core import build
from triton_distributed_tpu_torch.ops import matmul as mm
from triton_distributed_tpu_torch.tune import autotuner as at

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def fresh_tuner(tmp_path, monkeypatch):
    """A process-global tuner on a cache file of this test's own."""
    monkeypatch.setenv("TDT_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setattr(at, "_GLOBAL", at.Autotuner())


def _operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32))


def _within_one_bf16_ulp(got: torch.Tensor, f32: np.ndarray) -> None:
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(f32), 1e-30))) - 7)
    err = np.abs(got.float().numpy() - f32)
    assert (err <= ulp).all(), float((err / ulp).max())


@pytest.mark.parametrize("m,k,n", [(64, 64, 96), (37, 136, 136)])
def test_matmul_f32_matches_jax(m, k, n):
    a, b = _operands(m, k, n)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    want_xla = np.asarray(jax_matmul(jnp.asarray(a), jnp.asarray(b),
                                     config=XlaBackend()))
    for got in (tt.matmul(ta, tb, bm=64, bn=64, bk=16),
                tt.matmul(ta, tb, config=tt.LibraryBackend()),
                tt.matmul(ta, tb)):
        assert got.dtype == torch.float32 and got.shape == (m, n)
        np.testing.assert_allclose(got.numpy(), want_xla, atol=1e-5, rtol=1e-5)
    if m % 32 == 0:   # the Pallas tile: JAX clips it to a divisor of each dim
        want = np.asarray(jax_matmul(jnp.asarray(a), jnp.asarray(b),
                                     bm=32, bn=32, bk=32))
        np.testing.assert_allclose(tt.matmul(ta, tb, bm=64, bn=64, bk=16).numpy(),
                                   want, atol=1e-5, rtol=1e-5)


def test_matmul_bf16_matches_jax_and_out_dtype():
    a, b = _operands(64, 128, 128, seed=1)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    ta, tb = (torch.from_numpy(x).to(torch.bfloat16) for x in (a, b))
    f32 = np.asarray(jnp.matmul(ja.astype(jnp.float32), jb.astype(jnp.float32)))
    pallas = jax_matmul(ja, jb, bm=64, bn=64, bk=64)
    _within_one_bf16_ulp(torch.from_numpy(np.array(pallas.astype(jnp.float32))), f32)
    for tile in mm.KERNEL_TILES[torch.bfloat16]:
        got = tt.matmul(ta, tb, config=tile)
        assert got.dtype == torch.bfloat16
        _within_one_bf16_ulp(got, f32)
    _within_one_bf16_ulp(tt.matmul(ta, tb, config=tt.LibraryBackend()), f32)
    # an f32 result of bf16 operands: the f32 sum itself
    want = np.asarray(jax_matmul(ja, jb, bm=64, bn=64, bk=64,
                                 out_dtype=jnp.float32))
    for cfg in ((128, 256, 64), tt.LibraryBackend()):
        got = tt.matmul(ta, tb, config=cfg, out_dtype=torch.float32)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_matmul_errors():
    with pytest.raises(ValueError, match="inner dims mismatch"):
        tt.matmul(torch.zeros(128, 64), torch.zeros(128, 64))
    a = torch.zeros(64, 64, dtype=torch.bfloat16)
    # an explicit tile must be one K6 is built for (no clip to a divisor)
    with pytest.raises(at.TileInfeasible, match="no torch.bfloat16 kernel"):
        tt.matmul(a, a, bm=32, bn=32, bk=32)
    with pytest.raises(ValueError):   # TileInfeasible is a ValueError
        tt.matmul(a, a, bm=512)
    with pytest.raises(at.TileInfeasible, match="multiples of 8"):
        tt.matmul(torch.zeros(8, 12, dtype=torch.bfloat16),
                  torch.zeros(12, 8, dtype=torch.bfloat16), bm=128)


def test_k6_operand_layout_is_copied_not_refused():
    """K6 reads row-major, 16-byte aligned operands; a strided or offset
    tensor is copied into that layout instead of refusing the tile, so a
    layout never makes a sweep skip K6 and persist the library's crown."""
    base = torch.arange(64 * 72, dtype=torch.float32).reshape(64, 72).to(torch.bfloat16)
    dense = mm._dense(base)
    assert dense is base
    strided = base.t()
    got = mm._dense(strided)
    assert got.is_contiguous() and torch.equal(got, strided)
    offset = base.reshape(-1)[1:1 + 64 * 64].reshape(64, 64)
    assert offset.is_contiguous() and offset.data_ptr() % 16
    got = mm._dense(offset)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, offset)


# ---------------------------------------------------------------------------
# the tuner


def test_picks_fastest_candidate(tmp_path):
    tuner = at.Autotuner(path=str(tmp_path / "cache.json"))
    calls = []

    def make_thunk(c):
        def thunk():
            calls.append(c)
            time.sleep(0.002 * c)
            return torch.zeros(())
        return thunk

    res = tuner.tune("toy", ("k",), [3, 1, 2], make_thunk, iters=2)
    assert res.config == 1 and not res.from_cache
    assert res.candidate_ms[1] == min(res.candidate_ms)
    n_calls = len(calls)
    res2 = tuner.tune("toy", ("k",), [3, 1, 2], make_thunk, iters=2)
    assert res2.config == 1 and res2.from_cache
    assert len(calls) == n_calls


def test_infeasible_skipped_and_launch_errors_propagate(tmp_path):
    tuner = at.Autotuner(path=str(tmp_path / "cache.json"))

    def make_thunk(c):
        def thunk():
            if c.startswith("infeasible"):
                raise at.TileInfeasible("not built")
            if c == "broken":
                raise RuntimeError("matmul: CUDA launch failed with cudaError_t 700")
            return torch.zeros(())
        return thunk

    res = tuner.tune("toy", ("k2",), ["infeasible", "good"], make_thunk, iters=1)
    assert res.config == "good"
    with pytest.raises(RuntimeError, match="every candidate was infeasible"):
        tuner.tune("toy", ("k3",), ["infeasible", "infeasible2"], make_thunk,
                   iters=1)
    # a launch failure is never skipped: it would crown the other candidate
    with pytest.raises(RuntimeError, match="cudaError_t 700"):
        tuner.tune("toy", ("k4",), ["good", "broken"], make_thunk, iters=1)
    # a single candidate is not measured at all
    probed = []
    res1 = tuner.tune("toy", ("k5",), ["only"],
                      lambda c: (lambda: probed.append(c)), iters=1)
    assert res1.config == "only" and res1.from_cache and not probed


@pytest.mark.parametrize("failure", ["build", "launch"])
def test_k6_failure_in_sweep_raises_and_crowns_nothing(monkeypatch, failure):
    """The matmul sweep with K6 failing to build or to launch raises; it
    does not crown the library.  The operands are routed to the kernel as
    CUDA tensors are (the CPU has no card)."""
    monkeypatch.setattr(mm, "_on_card", lambda t: True)
    monkeypatch.setattr(mm, "_stream", lambda device: 0)
    if failure == "build":
        def broken():
            raise build.KernelBuildError("nvcc failed on matmul.cu")
        monkeypatch.setattr(build, "library", broken)
        expect = build.KernelBuildError
    else:
        class Lib:
            @staticmethod
            def tdt_matmul(*args):
                return 700   # cudaErrorIllegalAddress
        monkeypatch.setattr(build, "library", lambda: Lib)
        expect = RuntimeError
    a = torch.randn(64, 64).to(torch.bfloat16)
    with pytest.raises(expect):
        at.fresh_tune_matmul(a, a)
    key = at.matmul_resolve_key(64, 64, 64, a.dtype)
    cands = at.matmul_candidates_pruned(64, 64, 64, a.dtype)
    assert at.lookup_winner("matmul", key, cands) is None
    with pytest.raises(expect):   # an explicit tile on the card: K6 or raise
        tt.matmul(a, a, bm=128, bn=256, bk=64)


def test_persistence_round_trip(tmp_path):
    path = str(tmp_path / "cache.json")
    at.Autotuner(path=path).tune(
        "toy", ("k",), [10, 1], lambda c: (lambda: time.sleep(0.001 * c)),
        iters=1)
    assert list(json.load(open(path)).values()) == [1]
    timed = []
    res = at.Autotuner(path=path).tune(
        "toy", ("k",), [10, 1], lambda c: (lambda: timed.append(c)), iters=1)
    assert res.config == 1 and res.from_cache and not timed


def _fake_sweep(monkeypatch, tuner, sweep_ms, confirm_ms):
    """Replace the timing: the sweep's medians and the confirmation's
    head-to-head samples ({0: challenger, 1: baseline}, seconds)."""
    monkeypatch.setattr(
        tuner, "_measure_interleaved",
        lambda thunks, iters, rounds=5, target_window_s=0.15:
        {i: sweep_ms[i] for i in thunks})

    def samples(thunks, iters, rounds, target_window_s=None):
        return {0: [(confirm_ms[0] / 1e3,) * 2] * rounds,
                1: [(confirm_ms[1] / 1e3,) * 2] * rounds}

    monkeypatch.setattr(at, "interleaved_time_samples", samples)


def test_fresh_fine_margin_crown_not_persisted(tmp_path, monkeypatch):
    def run(sweep, confirm, name):
        path = tmp_path / f"{name}.json"
        tuner = at.Autotuner(path=str(path))
        _fake_sweep(monkeypatch, tuner, sweep, confirm)
        res = tuner.tune("toy", ("k",), [0, 1],
                         lambda c: (lambda: torch.zeros(())),
                         baseline_index=0, margin=0.08, fresh=True)
        return res.config, json.loads(path.read_text()) if path.exists() else {}

    # ~3 % better: above the fine 1.5 %, below the full 8 %: this process only
    cfg, disk = run({0: 1.00, 1: 0.97}, (0.97, 1.00), "fine")
    assert cfg == 1 and disk == {}
    # 20 % better: crowned and persisted
    cfg, disk = run({0: 1.00, 1: 0.80}, (0.80, 1.00), "full")
    assert cfg == 1 and list(disk.values()) == [1]
    # a challenger that loses the head-to-head keeps the default
    cfg, _ = run({0: 1.00, 1: 0.97}, (1.00, 1.00), "lost")
    assert cfg == 0


def test_fresh_fine_margin_crown_demotes_stale_disk_winner(tmp_path, monkeypatch):
    path = tmp_path / "cache.json"
    tuner = at.Autotuner(path=str(path))
    _fake_sweep(monkeypatch, tuner, {0: 1.00, 1: 1.00, 2: 0.70}, (0.70, 1.00))
    res = tuner.tune("toy", ("k",), [0, 1, 2], lambda c: (lambda: torch.zeros(())),
                     baseline_index=0, margin=0.08, fresh=True)
    assert res.config == 2 and list(json.loads(path.read_text()).values()) == [2]
    tuner2 = at.Autotuner(path=str(path))
    _fake_sweep(monkeypatch, tuner2, {0: 1.00, 1: 0.97, 2: 1.10}, (0.97, 1.00))
    res2 = tuner2.tune("toy", ("k",), [0, 1, 2], lambda c: (lambda: torch.zeros(())),
                       baseline_index=0, margin=0.08, fresh=True)
    assert res2.config == 1 and json.loads(path.read_text()) == {}


def test_prune_infeasible_drops_over_budget_tiles(monkeypatch):
    """Built tiles fit; a tile over the shared-memory or register budget,
    or one K6 is not built for, is dropped before measuring (a ring one
    stage deeper than the built one included); the default and the library
    pass through."""
    bf16 = torch.bfloat16
    dims = dict(m=8192, n=8192, k=8192, dtype=bf16)
    assert mm.DEFAULT_TILES[bf16] in mm.KERNEL_TILES[bf16]
    for tile, spec in mm.KERNEL_TILES[bf16].items():
        assert spec.acc_threads == 256
        assert spec.smem_bytes(*tile) <= footprint.SMEM_PER_BLOCK
        assert footprint.config_feasible("matmul", tile, dims) == []
    # the wgmma ring: four 48 KB stages and 1 KB of alignment, an m64n256
    # accumulator a consumer thread
    assert mm.KERNEL_TILES[bf16][(128, 256, 64)].smem_bytes(128, 256, 64) == 4 * 48 * 1024 + 1024
    assert footprint.matmul((128, 256, 64), **dims).acc_regs == 128
    f32 = mm.KERNEL_TILES[torch.float32][(64, 64, 16)]
    assert f32.acc_threads == 256
    assert footprint.matmul((64, 64, 16), 64, 64, 64, torch.float32).acc_regs == 16
    tiles = dict(mm.KERNEL_TILES[bf16])
    tiles[(256, 256, 128)] = mm.TileSpec(2, 4)   # ~513 KB of stages
    tiles[(256, 256, 32)] = mm.TileSpec(1, 2)    # 512 accumulators a thread
    monkeypatch.setitem(mm.KERNEL_TILES, bf16, tiles)
    default = tt.LibraryBackend()
    cands = [default, (128, 256, 64), (256, 256, 128), (256, 256, 32),
             (32, 32, 32)]
    kept = at.prune_infeasible("matmul", cands, default, dims)
    assert kept == [default, (128, 256, 64)]
    assert "shared memory" in footprint.config_feasible("matmul", (256, 256, 128), dims)[0]
    assert "accumulator registers" in footprint.config_feasible("matmul", (256, 256, 32), dims)[0]
    # one stage more than the ring holds does not fit 227 KB
    tiles[(128, 256, 64)] = mm.TileSpec(2, 5)
    assert tiles[(128, 256, 64)].smem_bytes(128, 256, 64) > footprint.SMEM_PER_BLOCK
    assert at.prune_infeasible("matmul", cands, default, dims) == [default]
    # the default is never pruned, unknown families never prune
    assert at.prune_infeasible("matmul", [(32, 32, 32)], (32, 32, 32), dims) == [(32, 32, 32)]
    assert at.prune_infeasible("no_such_family", [(9, 9, 9)], None, {}) == [(9, 9, 9)]
    # off the 8-element granule only the library is offered
    assert at.matmul_backend_candidates(64, 60, 64) == [default]


def test_all_matmul_resolve_paths_share_the_pruned_list(monkeypatch):
    monkeypatch.setattr(
        at, "matmul_backend_candidates",
        lambda m, n, k, dtype=None: [at.LibraryBackend(), (128, 256, 64),
                                     (32, 32, 32)])
    monkeypatch.setenv("TDT_AUTOTUNE", "0")
    seen = []
    real = at.resolve_config

    def spy(name, key, candidates, default, make_thunk, **kw):
        seen.append(list(candidates))
        return default

    monkeypatch.setattr(at, "resolve_config", spy)
    a = torch.ones(256, 256, dtype=torch.bfloat16)
    tt.matmul(a, a)
    tt.matmul_callable(a, a)
    tt.tuned_matmul(a, a)
    tt.fresh_tune_matmul(a, a)
    monkeypatch.setattr(at, "resolve_config", real)
    pruned = at.matmul_candidates_pruned(256, 256, 256, a.dtype)
    assert (32, 32, 32) not in pruned
    assert seen == [pruned] * 4


def test_cpu_tensors_never_measure(monkeypatch):
    """``matmul(config=None)`` on CPU tensors measures nothing, even with
    tuning forced on, and serves the default; a planted winner is still
    consulted."""
    monkeypatch.setenv("TDT_AUTOTUNE", "1")
    measured = []
    monkeypatch.setattr(at, "autotune", lambda *a, **k: measured.append(a))
    a, b = (torch.from_numpy(x) for x in _operands(64, 64, 64))
    got = tt.matmul(a, b)
    tt.tuned_matmul(a, b)
    assert tt.fresh_tune_matmul(a, b) == at.LibraryBackend()
    assert not measured
    np.testing.assert_allclose(got.numpy(), (a @ b).numpy(), atol=1e-5)
    cands = at.matmul_candidates_pruned(64, 64, 64, a.dtype)
    key = at.matmul_resolve_key(64, 64, 64, a.dtype)
    at._GLOBAL._load_disk()[at._cache_key("matmul", key, cands)] = 1
    assert at.resolve_config("matmul", key, cands, at.LibraryBackend(),
                             None, on_card=False) == cands[1]


_MEAN_WORKER = """
import sys
import torch.distributed as dist
from triton_distributed_tpu_torch.core.utils import process_mean
rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
print(process_mean([rank, 10.0 * rank, 1.5]))
dist.destroy_process_group()
"""


def test_process_mean_over_two_gloo_processes():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, "-c", _MEAN_WORKER, str(r), str(port)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            outs.append(out.strip())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert outs == ["[0.5, 5.0, 1.5]"] * 2
    assert at.process_mean([1.0, 2.0]) == [1.0, 2.0]   # one process: unchanged
