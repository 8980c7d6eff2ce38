"""Capture a model step once, then replay it without running its Python
(counterpart of ``triton_distributed_tpu/tools/aot.py``).

The JAX package compiles a step ahead of time (``.lower().compile()``) and
serializes the executable, so a serving process never traces.  PyTorch runs
eagerly, and its counterpart of "compile once, then serve without tracing" is
a CUDA graph: the step's kernel launches are recorded once on a capture
stream and replayed with one host call, at the device addresses recorded.
So a replay reads its inputs from static buffers, writes its outputs to
static buffers, and reads every other tensor (weights, the KV cache and its
device-resident length) where it lay at capture.  A step that read a length
on the host would freeze it into every replay; the port's caches keep their
lengths on the device (``models/kv_cache.py``).

A CUDA graph holds device addresses of this process's allocations, so it
cannot be serialized.  :func:`save` and :func:`load` write and read the JSON
manifest only (the buckets, the batch, the model's fingerprint); a second
process captures again from it (``Engine.load_precompiled``), on kernels
already built from the checkout (``core/build.py`` keeps the library on
disk, keyed by the sources' hash), so it runs no ``nvcc``.

Every graph of an engine draws from one memory pool: only one replays at a
time, and what outlives a replay is copied out of its static outputs
(:meth:`Captured.__call__` returns the static tensors; the caller copies).
The collectives' signal pads and landing buffers (``core/symm.py``) are kept
per stream: the warm-up runs on the capture stream, so they exist at their
full size before the capture (``core/symm.py`` refuses to grow one during a
capture), and a :class:`Captured` keeps a reference to every one of them, so
a later growth never frees memory a graph addresses.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Sequence

import torch


class Captured:
    """``fn(*inputs)`` captured as a CUDA graph.

    ``example_inputs`` (CUDA tensors) are copied into static input buffers;
    ``fn`` runs once on ``stream`` (the warm-up: what a step allocates or
    builds at its first call happens there, not in the capture) and is then
    captured on it into ``pool`` (``torch.cuda.graph_pool_handle()``, shared
    with the caller's other graphs; None for a pool of its own).  ``fn``
    returns a tensor or a tuple of tensors: the static outputs, overwritten
    by every replay.  Raises without CUDA, and on any error the capture
    meets (nothing falls back to eager)."""

    def __init__(self, fn: Callable, example_inputs: Sequence[torch.Tensor], pool,
                 stream: torch.cuda.Stream):
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA graphs need a CUDA device; on the CPU run the step eagerly")
        if not all(t.is_cuda for t in example_inputs):
            raise ValueError("a captured step's inputs must be CUDA tensors")
        from ..core import symm

        self.inputs = [t.detach().clone() for t in example_inputs]
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        with torch.cuda.stream(stream):
            fn(*self.inputs)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, stream=stream):
            self.outputs = fn(*self.inputs)
        # the pads and landing buffers the graph's collectives address
        self.held = symm.live_buffers()

    def __call__(self, *inputs: torch.Tensor):
        """Copy ``inputs`` into the static buffers, replay, and return the
        static outputs (valid until the next replay of a graph of the pool)."""
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(x)
        self.graph.replay()
        return self.outputs


def save(manifest: dict, path: str) -> None:
    """Write a manifest as JSON, atomically."""
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
