"""Small shared helpers: integer tiling math, comparison, and kernel timing
with CUDA events (counterpart of ``triton_distributed_tpu/core/utils.py``)."""

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
