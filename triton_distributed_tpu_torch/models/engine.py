"""Inference engine: prefill, then token-by-token decode, with a timed
``serve`` (counterpart of ``triton_distributed_tpu/models/engine.py``).

The JAX engine jits each step with the cache donated; PyTorch runs eagerly
and the cache is updated in place, so a step here is a plain call.  Capturing
the decode step in a CUDA graph, the observability spans, the flight
recorder, request deadlines, AOT prompt buckets and ``scheduler()`` belong to
later slices of the port.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ..core.mesh import Mesh
from .config import ModelConfig
from .kv_cache import init_cache, init_paged_cache, reset
from ..ops.persistent_decode import stack_decode_params
from .qwen import Qwen3, QwenParams


def sample_token(logits: torch.Tensor, generator: torch.Generator | None = None,
                 *, temperature: float = 0.0, top_p: float = 1.0) -> torch.Tensor:
    """Greedy / temperature / nucleus sampling over (B, V) f32 logits
    (reference ``sample_token``).  Greedy is exact (the first maximum wins,
    as ``jnp.argmax``); the sampled path draws from ``generator``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temperature
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # smallest set with cumulative probability >= top_p
        cutoff_idx = torch.argmax((cum >= top_p).to(torch.int8), dim=-1)
        cutoff = sorted_logits.gather(-1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff,
                             torch.full_like(logits, float("-inf")), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


@dataclasses.dataclass
class Engine:
    """Owns the model, its parameters and the KV cache.

    ``cache_layout``: "contiguous" (one shared length) or "paged" (page pool
    + block table + ragged per-sequence lengths).  ``kv_dtype``: None keeps
    the model dtype; "int8" selects the quantized paged layout (one f32
    scale per (layer, page, head)), paged only and at tp = 1.  A model on a
    mesh gets the head-sharded cache of its ranks (``models/kv_cache.py``);
    ``batch`` counts sequences, which every rank serves."""

    model: Qwen3
    params: QwenParams
    batch: int = 1
    temperature: float = 0.0
    top_p: float = 1.0
    cache_layout: str = "contiguous"
    page_size: int = 64
    kv_dtype: str | None = None

    def __post_init__(self):
        self._stacked = None
        c = self.model.config
        dev, tp = self.model.device, self.model.tp
        if self.cache_layout == "paged":
            self.cache = init_paged_cache(
                c.num_layers, self.batch, c.num_kv_heads, c.max_length,
                c.head_dim, c.dtype, page_size=self.page_size, device=dev,
                kv_dtype=self.kv_dtype, tp=tp)
        elif self.cache_layout == "contiguous":
            if self.kv_dtype is not None:
                raise ValueError(
                    "kv_dtype quantization needs cache_layout='paged' (the "
                    "per-(page, head) scale layout)")
            self.cache = init_cache(c.num_layers, self.batch, c.num_kv_heads,
                                    c.max_length, c.head_dim, c.dtype,
                                    device=dev, tp=tp)
        else:
            raise ValueError(f"cache_layout {self.cache_layout!r} not in "
                             "('contiguous', 'paged')")

    @classmethod
    def build(cls, config: ModelConfig, *, mesh: Mesh | None = None, device=None,
              generator: torch.Generator | None = None, batch: int = 1,
              max_length: int | None = None, decode_mode: str = "psum",
              **kw) -> "Engine":
        """A model with random weights from ``generator`` (seed 0 when None)
        on ``device`` (CUDA unless the caller passes "cpu"; raises without
        CUDA), or on the co-located ranks of ``mesh`` (``make_mesh({"tp":
        4})``: tensor parallel, its cache head-sharded).  ``max_length``
        overrides the config's cache length; ``decode_mode`` is the model's."""
        if max_length is not None:
            config = dataclasses.replace(config, max_length=max_length)
        model = Qwen3(config, device=device, decode_mode=decode_mode, mesh=mesh)
        return cls(model, model.init(generator), batch=batch, **kw)

    @property
    def device(self) -> torch.device:
        return self.model.device

    def stacked(self):
        """The persistent kernel's layer table of these parameters, built
        once (JAX's ``EngineBackend`` hoists it out of the step); None in
        the other modes."""
        if self.model.decode_mode != "persistent" or self.model.config.is_moe:
            return None
        if self._stacked is None or self._stacked.layers[0] is not self.params.layers[0]:
            self._stacked = stack_decode_params(self.params)
        return self._stacked

    def set_decode_mode(self, mode: str) -> None:
        """Swap the decode-step chain (reference ``set_fwd``): "psum", "ar",
        "gemm_ar", "fused" or "persistent"; parameters and cache are kept.
        The engine gets a model of its own, so an engine sharing the old
        model keeps its mode."""
        m = self.model
        self.model = Qwen3(m.config, device=m.device, decode_mode=mode,
                           mesh=m.mesh, axis=m.axis)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _check_length(self, prompt_len: int, gen_len: int) -> None:
        max_len = self.model.config.max_length
        if prompt_len + gen_len > max_len:
            raise ValueError(f"prompt {prompt_len} + gen_len {gen_len} exceeds "
                             f"max_length={max_len}")

    def prefill(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Run the prompt (B, S) from an empty cache; returns the last
        position's f32 logits (B, V)."""
        b, plen = input_ids.shape
        if b != self.batch:
            raise ValueError(f"input_ids batch {b} does not match engine batch "
                             f"{self.batch}")
        if plen > self.model.config.max_length:
            raise ValueError(f"prompt length {plen} exceeds max_length="
                             f"{self.model.config.max_length}")
        reset(self.cache)
        logits, self.cache = self.model.prefill(self.params, self.cache,
                                                input_ids.to(self.device))
        return logits[:, -1]

    def decode_step(self, tokens: torch.Tensor) -> torch.Tensor:
        logits, self.cache = self.model.decode(self.params, self.cache,
                                               tokens.to(self.device), stacked=self.stacked())
        return logits

    def decode_multi(self, tokens: torch.Tensor, steps: int) -> torch.Tensor:
        """``steps`` greedy steps with the argmax fed back on the device
        (``Qwen3.decode_multi``).  Returns (steps, B) int32 tokens."""
        toks, self.cache = self.model.decode_multi(self.params, self.cache,
                                                   tokens.to(self.device), steps,
                                                   stacked=self.stacked())
        return toks

    def generate(self, input_ids: torch.Tensor, gen_len: int,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """Prefill + ``gen_len - 1`` decode steps.  Returns (B, gen_len)
        int32 token ids."""
        self._check_length(input_ids.shape[1], gen_len)
        return self.generate_from_logits(self.prefill(input_ids), gen_len,
                                         generator)

    def generate_from_logits(self, logits: torch.Tensor, gen_len: int,
                             generator: torch.Generator | None = None
                             ) -> torch.Tensor:
        """The decode loop given the prefill's last-position logits."""
        tok = sample_token(logits, generator, temperature=self.temperature,
                           top_p=self.top_p)
        outs = [tok]
        for _ in range(gen_len - 1):
            tok = sample_token(self.decode_step(tok), generator,
                               temperature=self.temperature, top_p=self.top_p)
            outs.append(tok)
        return torch.stack(outs, dim=1)

    def serve(self, input_ids: torch.Tensor, gen_len: int,
              generator: torch.Generator | None = None):
        """Timed generate (reference ``Engine.serve``).  Returns
        ``(tokens, stats)`` with ``prefill_ms``, ``decode_ms_per_token`` and
        ``decode_tokens_per_s`` on the host clock, each window ended by a
        device synchronize.  One prefill and one decode step run first,
        outside the timed window."""
        b, prompt_len = input_ids.shape
        self._check_length(prompt_len, gen_len)
        input_ids = input_ids.to(self.device)
        self.prefill(input_ids)
        self.decode_step(torch.zeros((b,), dtype=torch.int32,
                                     device=self.device))
        self._sync()
        t0 = time.perf_counter()
        logits = self.prefill(input_ids)
        self._sync()
        t1 = time.perf_counter()
        tokens = self.generate_from_logits(logits, gen_len, generator)
        self._sync()
        t2 = time.perf_counter()
        steps = max(gen_len - 1, 1)
        stats = {
            "prefill_ms": (t1 - t0) * 1e3,
            "decode_ms_per_token": (t2 - t1) * 1e3 / steps,
            "decode_tokens_per_s": b * steps / max(t2 - t1, 1e-9),
        }
        return tokens, stats
