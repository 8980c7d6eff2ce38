"""Inference engine: prefill, then token-by-token decode, with a timed
``serve`` and bucketed precompiled serving (counterpart of
``triton_distributed_tpu/models/engine.py``).

The JAX engine jits each step with the cache donated; PyTorch runs eagerly
and the cache is updated in place, so a step here is a plain call.
:meth:`Engine.precompile` is the counterpart of JAX's bucketed AOT serving
(``engine.py:398-494``): on the card it captures one prefill per prompt
bucket and the decode step as CUDA graphs (``tools/aot.py``), which then
serve without running the model's Python; the graphs read the contiguous
cache's length on the device.  The observability spans, the flight
recorder, request deadlines and ``scheduler()`` belong to later slices of
the port.
"""

from __future__ import annotations

import dataclasses
import os
import time

import torch

from ..core.mesh import TP_AXIS, Mesh
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


def arch_fingerprint(config: ModelConfig, mesh: Mesh | None, axis: str = TP_AXIS) -> dict:
    """JSON-safe identity of (model architecture, mesh topology), as JAX's
    (``engine.py:57-76``): every ModelConfig field (the dtype by its name,
    ``"bfloat16"``), the mesh's axis sizes (``{axis: 1}`` without a mesh)
    and the tp axis.  Saved in the manifest and compared at load."""
    cfg = {}
    for f in dataclasses.fields(config):
        v = getattr(config, f.name)
        cfg[f.name] = str(v).removeprefix("torch.") if f.name == "dtype" else v
    sizes = {axis: 1} if mesh is None else {str(a): int(n) for a, n in mesh.shape.items()}
    return {"model_config": cfg, "mesh": sizes, "axis": str(axis)}


def check_arch(manifest: dict, have: dict) -> None:
    """Raise ValueError naming every differing fingerprint field
    (``engine.py:79-97``).  A manifest without ``arch`` passes: the coarse
    batch/vocab/max_length checks still apply to it."""
    want = manifest.get("arch")
    if want is None or want == have:
        return
    diffs = []
    w_cfg, h_cfg = want.get("model_config", {}), have.get("model_config", {})
    for k in sorted(set(w_cfg) | set(h_cfg)):
        if w_cfg.get(k) != h_cfg.get(k):
            diffs.append(f"model.{k}: bundle={w_cfg.get(k)!r} engine={h_cfg.get(k)!r}")
    for k in ("mesh", "axis"):
        if want.get(k) != have.get(k):
            diffs.append(f"{k}: bundle={want.get(k)!r} engine={have.get(k)!r}")
    raise ValueError(
        "AOT bundle was compiled for a different model architecture / mesh "
        "topology: " + "; ".join(diffs or ["<unstructured fingerprint>"]))


@dataclasses.dataclass
class _Precompiled:
    """The state :meth:`Engine.precompile` leaves: the buckets, and on the
    card the graphs (prefill per bucket, the decode step), the parameters
    they read and their memory pool.  On the CPU the graphs are None and the
    dispatch runs the padded steps eagerly."""

    buckets: list[int]
    params: object
    prefill: dict | None = None
    decode: object = None


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
        self._aot: _Precompiled | None = None
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
        # the graphs hold the old mode's launches: precompile again
        self._aot = None

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
        input_ids = input_ids.to(self.device)
        bucket = self._bucket(plen)
        if bucket is not None:
            return self._prefill_bucket(input_ids, bucket)
        reset(self.cache)
        logits, self.cache = self.model.prefill(self.params, self.cache, input_ids)
        return logits[:, -1]

    def decode_step(self, tokens: torch.Tensor) -> torch.Tensor:
        tokens = tokens.to(self.device)
        if self._aot is not None and self._aot.decode is not None:
            self._check_aot_params()
            return self._aot.decode(tokens.to(torch.int32)).clone()
        logits, self.cache = self.model.decode(self.params, self.cache, tokens,
                                               stacked=self.stacked())
        return logits

    # -- bucketed precompiled serving ---------------------------------------

    _MANIFEST = "aot_manifest.json"

    def _bucket(self, plen: int) -> int | None:
        """The smallest precompiled bucket >= ``plen``; None without buckets
        or past the largest (that prompt runs the eager path, as JAX's falls
        through to jit)."""
        if self._aot is None:
            return None
        return min((b for b in self._aot.buckets if b >= plen), default=None)

    def _check_aot_params(self) -> None:
        if self.params is not self._aot.params:
            raise RuntimeError("the engine's parameters were replaced after precompile: "
                               "the graphs read the old ones; call precompile again")

    def _padded_prefill(self, ids: torch.Tensor, true_len: torch.Tensor) -> torch.Tensor:
        """The bucket step: prefill of the right-padded ``ids`` with the
        cache length set to ``true_len`` (a device scalar), and the logits at
        ``true_len - 1`` gathered on the device: (B, V) f32."""
        logits, _ = self.model.prefill(self.params, self.cache, ids, true_len)
        return logits.index_select(1, (true_len - 1).reshape(1).long())[:, 0]

    def _prefill_bucket(self, input_ids: torch.Tensor, bucket: int) -> torch.Tensor:
        b, plen = input_ids.shape
        ids = torch.nn.functional.pad(input_ids.to(torch.int32), (0, bucket - plen))
        true_len = torch.full((), plen, dtype=torch.int32, device=self.device)
        graphs = self._aot.prefill
        if graphs is None:   # the caller's CPU engine: the padded step, eagerly
            return self._padded_prefill(ids, true_len)
        self._check_aot_params()
        return graphs[bucket](ids, true_len).clone()

    def _manifest(self) -> dict:
        c = self.model.config
        return {"buckets": list(self._aot.buckets), "batch": self.batch,
                "max_length": c.max_length, "vocab": c.vocab,
                "decode_mode": self.model.decode_mode, "cache_layout": self.cache_layout,
                "arch": arch_fingerprint(c, self.model.mesh, self.model.axis)}

    def precompile(self, prompt_buckets, save_dir: str | None = None) -> dict:
        """Capture prefill for each prompt-length bucket and the decode step
        as CUDA graphs (JAX ``engine.py:398-463`` compiles them ahead of
        time); with ``save_dir`` write the manifest there.  Returns the
        manifest.

        A prompt is then right-padded to the smallest bucket >= its length
        and replayed with its true length as a device scalar (the cache
        length is set to it, the logits at ``true_len - 1`` gathered on the
        device), so one graph is exact for every length it covers; a longer
        prompt runs the eager path.  The contiguous layout only, as JAX's;
        dense models only.  On an engine the caller put on the CPU the
        buckets are recorded and the padded steps run eagerly.  On CUDA a
        capture that fails raises ``NotImplementedError`` naming the mode
        and the error; nothing is served eagerly in its place."""
        if self.cache_layout != "contiguous":
            raise ValueError("bucketed AOT serving supports the contiguous cache layout")
        c = self.model.config
        if c.is_moe:
            raise NotImplementedError("precompile of a MoE model is not ported yet (ROADMAP A8)")
        buckets = sorted(set(int(x) for x in prompt_buckets))
        if not buckets or buckets[0] < 1 or buckets[-1] > c.max_length:
            raise ValueError(f"buckets must be within [1, max_length={c.max_length}]; "
                             f"got {buckets}")
        self._aot = None
        self._aot = self._capture(buckets)
        manifest = self._manifest()
        if save_dir is not None:
            from ..tools import aot

            os.makedirs(save_dir, exist_ok=True)
            aot.save(manifest, os.path.join(save_dir, self._MANIFEST))
        return manifest

    def load_precompiled(self, save_dir: str) -> dict:
        """Serve the buckets of a manifest :meth:`precompile` saved (JAX
        ``engine.py:465-494``), in another process: the fields and the
        architecture are checked first (a mismatch raises ValueError naming
        the field), then the graphs are captured, on kernels already built.
        Returns the manifest."""
        from ..tools import aot

        manifest = aot.load(os.path.join(save_dir, self._MANIFEST))
        c = self.model.config
        mine = {"batch": self.batch, "max_length": c.max_length, "vocab": c.vocab,
                "decode_mode": self.model.decode_mode, "cache_layout": self.cache_layout}
        for field, have in mine.items():
            want = manifest.get(field)
            if want != have:
                raise ValueError(f"AOT bundle was compiled for {field}={want!r}; this "
                                 f"engine has {field}={have!r}")
        check_arch(manifest, arch_fingerprint(c, self.model.mesh, self.model.axis))
        self.precompile(manifest["buckets"])
        return manifest

    def _capture(self, buckets: list[int]) -> _Precompiled:
        """The graphs of ``buckets`` and of the decode step, on one capture
        stream and one memory pool, the largest bucket first: a step's
        warm-up then never grows a buffer that a graph captured before it
        addresses (and each graph holds the ones it does)."""
        pre = _Precompiled(buckets=buckets, params=self.params)
        if self.device.type != "cuda":
            return pre
        from ..tools import aot

        b, dev = self.batch, self.device
        stream, pool = torch.cuda.Stream(dev), torch.cuda.graph_pool_handle()
        what = "prefill"
        try:
            pre.prefill = {}
            for L in sorted(buckets, reverse=True):
                what = f"prefill bucket {L}"
                pre.prefill[L] = aot.Captured(
                    self._padded_prefill,
                    [torch.zeros((b, L), dtype=torch.int32, device=dev),
                     torch.full((), L, dtype=torch.int32, device=dev)], pool, stream)
            what = "the decode step"
            pre.decode = aot.Captured(
                lambda t: self.model.decode(self.params, self.cache, t)[0],
                [torch.zeros((b,), dtype=torch.int32, device=dev)], pool, stream)
        except RuntimeError as e:
            raise NotImplementedError(
                f"CUDA-graph capture of {what} in decode_mode {self.model.decode_mode!r} at "
                f"tp = {self.model.tp} failed: {e}") from e
        finally:
            reset(self.cache)
        return pre

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
