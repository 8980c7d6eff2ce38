"""Small shared helpers: integer tiling math, comparison, kernel timing with
CUDA events, the autotuner's interleaved host-clock timing, and the
cross-process mean (counterpart of ``triton_distributed_tpu/core/utils.py``)."""

from __future__ import annotations

import statistics
import time
from typing import Callable

import numpy as np
import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def clip_block(block: int, dim: int) -> int:
    """Largest divisor of ``dim`` that is <= ``block`` (at least 1), used to
    cut a dimension into equal tiles.  The TPU version also prefers
    multiples of the 8-row sublane; a GPU block has no such granule."""
    b = max(1, min(block, dim))
    while dim % b:
        b -= 1
    return b


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def assert_allclose(actual, expected, *, atol: float = 1e-2,
                    rtol: float = 1e-2, max_mismatch_report: int = 10,
                    name: str = "tensor") -> None:
    """Elementwise ``|a - e| <= atol + rtol * |e|`` with a mismatch dump;
    NaN anywhere counts as a mismatch."""
    a, e = _to_numpy(actual), _to_numpy(expected)
    if a.shape != e.shape:
        raise AssertionError(f"{name}: shape mismatch {a.shape} vs {e.shape}")
    err = np.abs(a - e)
    bad = ~(err <= atol + rtol * np.abs(e))
    if bad.any():
        idxs = np.argwhere(bad)
        worst = np.unravel_index(np.nanargmax(np.where(bad, err, -1)), a.shape)
        lines = [f"{name}: {len(idxs)}/{a.size} mismatched, atol={atol} "
                 f"rtol={rtol}, max abs err {err[worst]:.6g} at {worst}"]
        for i in idxs[:max_mismatch_report]:
            t = tuple(i)
            lines.append(f"  [{t}] actual={a[t]:.6g} expected={e[t]:.6g}")
        raise AssertionError("\n".join(lines))


SPIN_CYCLES_PER_S = 2e9   # at or above the H100's SM clock: a spin lasts at least as asked


def perf_func(func: Callable[[], object], iters: int = 20,
              warmup_iters: int = 3) -> tuple[object, float]:
    """(last output, median ms per call) of a CUDA thunk, each call timed by
    its own pair of CUDA events after ``warmup_iters`` untimed calls
    (reference ``perf_func``, ``utils.py:269-281``).

    The events time device work only: before the timed calls a spin kernel
    holds the stream for longer than the host needs to enqueue all of them,
    so the calls run back to back and a call whose launch costs the host more
    than its kernels cost the device is not charged for the gap.  Raises
    without CUDA: a host-clock number is not a device time."""
    if not torch.cuda.is_available():
        raise RuntimeError("perf_func times CUDA work and needs a CUDA device")
    out = None
    for _ in range(warmup_iters):
        out = func()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    func()
    torch.cuda.synchronize()
    per_call_s = time.perf_counter() - t0  # host and device: an upper bound on either
    torch.cuda._sleep(int(min(2.0 * iters * per_call_s, 2.0) * SPIN_CYCLES_PER_S))
    events = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = func()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return out, statistics.median(s.elapsed_time(e) for s, e in events)


def sync() -> None:
    """Wait until the device has finished the work queued so far (JAX
    ``sync``): ``torch.cuda.synchronize()`` once CUDA is in use, nothing on
    a CPU-only process, whose PyTorch ops finish before they return."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed_run(func: Callable[[], object], k: int) -> float:
    """Host seconds for ``k`` back-to-back calls of ``func`` ended by one
    :func:`sync` (JAX ``timed_run``)."""
    t0 = time.perf_counter()
    for _ in range(k):
        func()
    sync()
    return time.perf_counter() - t0


def interleaved_time_samples(thunks: dict, iters: int, rounds: int,
                             target_window_s: float | None = None) -> dict:
    """Per-thunk ``(slope_dt, raw_dt)`` second-per-call samples over
    interleaved rounds, the measurement core of the autotuner (JAX
    ``core/utils.py:132``, ported line for line; the windows are host-clock
    spans ended by ``torch.cuda.synchronize()``).

    Thunks timed back to back in a round share the card's clock and thermal
    state; the order alternates between rounds so a monotonic drift biases
    no thunk.  ``slope_dt`` is the slope between a 1-call and a (1 + k)-call
    window (the fixed sync cost cancels: an unbiased absolute); ``raw_dt`` is
    the (1 + k)-call window over 1 + k (sync cost included, but common to
    every thunk, so the right basis for ratios and crowning).  With
    ``target_window_s`` each thunk's call count is recalibrated every round
    from its latest raw time so every window lasts about that long.  Two
    thunks run A B B A windows after round 0, so a linear drift cancels in
    their ratio.  Callers warm the thunks up first and drop round 0 of the
    raw samples (taken before the windows were calibrated)."""
    samples = {name: [] for name in thunks}
    trips = {name: iters for name in thunks}

    def recalibrate(name, raw_dt):
        if target_window_s and raw_dt > 0:
            trips[name] = max(iters, min(int(target_window_s / raw_dt), 8192))

    for r in range(rounds):
        order = list(thunks.items())
        if r % 2:
            order.reverse()
        if len(order) == 2 and r > 0:
            (na, fa), (nb, fb) = order
            ka, kb = trips[na], trips[nb]
            # the 1-call calibrations sit beside the long window they are
            # differenced against, placed symmetrically so both thunks'
            # mean window times still coincide
            a1 = timed_run(fa, 1 + ka)
            cal_a = timed_run(fa, 1)
            b1 = timed_run(fb, 1 + kb)
            b2 = timed_run(fb, 1 + kb)
            cal_b = timed_run(fb, 1)
            a2 = timed_run(fa, 1 + ka)
            raw_a = (a1 + a2) / (2 * (1 + ka))
            raw_b = (b1 + b2) / (2 * (1 + kb))
            samples[na].append(((a1 - cal_a) / ka, raw_a))
            samples[nb].append(((b2 - cal_b) / kb, raw_b))
            recalibrate(na, raw_a)
            recalibrate(nb, raw_b)
            continue
        for name, thunk in order:
            k = trips[name]
            t_long = timed_run(thunk, 1 + k)
            raw_dt = t_long / (1 + k)
            samples[name].append(((t_long - timed_run(thunk, 1)) / k, raw_dt))
            recalibrate(name, raw_dt)
    return samples


def process_mean(values) -> list[float]:
    """Elementwise mean of a small float vector over the processes of the
    default ``torch.distributed`` group, identical on every process (JAX
    ``process_mean``: what lets every rank's tuner crown the same winner).
    Unchanged when ``torch.distributed`` is not initialized or has one
    process."""
    import torch.distributed as dist

    values = [float(v) for v in values]
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return values
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor(values, dtype=torch.float64, device=device)
    dist.all_reduce(t)
    return (t / dist.get_world_size()).tolist()
