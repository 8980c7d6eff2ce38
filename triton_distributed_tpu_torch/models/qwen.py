"""Qwen3 decoder, dense or MoE at tp = 1, dense or MoE under expert
parallelism on a mesh of tp co-located ranks (counterpart of
``triton_distributed_tpu/models/qwen.py::Qwen3``).

At tp = 1 every collective of the JAX model falls back to a plain matrix
product (``ops/ag_gemm.py:316``, ``ops/gemm_rs.py:268``, the decode
reductions at ``qwen.py:182-190`` and ``:703-718``, and the fused mode's
``fused_decode.py:756-762, 851-853``).  Those stay ``torch.matmul`` here.
Attention runs through the hand-written kernels: flash attention in
prefill; in each decode step the contiguous or paged decode kernel
(``decode_mode="psum"``), or, on a paged cache in ``decode_mode="fused"``,
the attention megakernel that also projects, normalizes, rotates and
appends (``ops.fused_decode``).  Both modes serve int8 page pools.
A MoE config (Qwen3-MoE) swaps every layer's MLP for the routed experts of
``layers.moe``, their expert products on the grouped-GEMM kernel: under
``moe_strategy="tp"`` at one rank ``forward_tp`` in prefill and
``forward_replicated`` in each decode step; under ``"ep"``
(``qwen.py:211-231``) ``forward_ep`` in prefill (the EP all-to-all, K17, and
with ``moe_fp8_wire`` the wire pack, K18, around the experts) and
``forward_replicated_ep`` in each decode step, at tp = 1 (JAX's one-rank
shortcut) and at tp = n, the experts partitioned over the ranks (rank r's
the rows ``[r E/n, (r + 1) E/n)`` of the tp = 1 tensors).

With ``mesh`` (``core/mesh.py``, tp = n > 1 co-located ranks) the model
runs the JAX package's tensor-parallel attention, its weights rank-stacked
(``layers/tp_attn.py``, ``layers/tp_mlp.py``) and its replicated weights
one copy:

- prefill (``qwen.py:273-309``): the residual stream row-sharded, (n, B S /
  n, K); each layer's qkv and gate_up through the AllGather-GEMM (K12), its
  o-projection and down through the GEMM-ReduceScatter (K13); the ranks'
  heads attend in one flash-attention launch, the rank folded into its
  batch; a MoE layer's MLP runs ``forward_ep`` on the row-sharded stream;
- decode: the activations replicated (one (B, K) copy), each rank's column
  products local, attention against the head-sharded cache on one decode
  kernel launch for all ranks, and the row-parallel reductions by
  ``decode_mode`` (``qwen.py:152-190, 695-734``): "psum" sums the ranks' f32
  partials (JAX leaves it to ``lax.psum``), "ar" runs the AllReduce (K11)
  on the partials, "gemm_ar" the GEMM-AllReduce (K14) when the batch divides
  by n, else the "ar" path.

  "fused" (``qwen.py:152-166``, ``:628-734``) runs every rank's attention
  on a paged cache in one launch of the attention megakernel (K4,
  rank-folded; a contiguous cache keeps the per-kernel attention) and both
  reductions on the fused GEMM + AllReduce ring (K15: the o-projection's
  ``fused_linear_ar``, the MLP's ``fused_mlp_ar``) where the dims divide;
  "persistent" (``:736-857``) runs all the layers of a step in one launch
  of the persistent kernel (K16) on a paged full-precision cache of a dense
  model (``_persistent_ok``), every other cache the "fused" chain, as JAX.

A MoE decode step runs ``forward_replicated_ep`` in every mode (the
attention by mode); "persistent" runs the "fused" chain for MoE, as JAX's
``_persistent_ok``.  MoE under ``moe_strategy="tp"`` and int8 pages at
tp > 1 raise (ROADMAP A7).  At tp = 1 "ar" and "gemm_ar" reduce
nothing and run as "psum", as in JAX; "persistent" on a paged cache runs
K16 at one rank (the plain version, JAX's n = 1 reference step, on the
CPU).

The model is a static definition; parameters (:class:`QwenParams`) and the
cache travel separately, as in the JAX package, so a test can hand both
implementations the same weights.  The cache is updated in place.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..comm.allreduce import all_reduce
from ..core.mesh import TP_AXIS, Mesh, shard, unshard
from ..core.platform import resolve_device
from ..layers import tp_mlp
from ..layers.moe import MoEMLP, MoEParams
from ..layers.norm import rms_norm
from ..layers.tp_attn import TPAttnParams, init_attn, shard_attn, split_heads
from ..layers.tp_mlp import TPMLPParams, init_mlp, mlp_forward, shard_mlp
from ..ops.attention import (
    decode_attention,
    flash_attention,
    paged_decode_attention,
)
from ..ops.ag_gemm import ag_gemm
from ..ops import persistent_decode as pd
from ..ops.fused_decode import fused_attn_decode, fused_linear_ar, fused_mlp_ar
from ..ops.gemm_ar import gemm_ar
from ..ops.gemm_rs import gemm_rs
from ..ops.matmul import batched_product
from ..ops.rope import apply_rope, rope_freqs
from .config import ModelConfig
from .kv_cache import (
    KVCache,
    PagedKVCache,
    advance,
    append_layer_quantized,
    append_token,
    layer_scales,
    with_length,
    write_prefill,
    write_prefill_paged,
)


@dataclasses.dataclass
class QwenLayerParams:
    ln1: torch.Tensor
    attn: TPAttnParams
    ln2: torch.Tensor
    mlp: TPMLPParams | MoEParams   # MoEParams when config.is_moe


@dataclasses.dataclass
class QwenParams:
    embed: torch.Tensor          # (V, K)
    layers: list[QwenLayerParams]
    final_norm: torch.Tensor     # (K,)
    lm_head: torch.Tensor        # (K, V), untied


def logits_f32(x: torch.Tensor, lm_head: torch.Tensor) -> torch.Tensor:
    """``x @ lm_head`` with an f32 result, as the JAX model's
    ``jnp.dot(..., preferred_element_type=f32)``.  A bf16 product rounded to
    bf16 would flip greedy near-ties; here the bf16 operands multiply with
    f32 accumulation and the sum is kept in f32: on CUDA through the GEMM's
    f32 output type, on the CPU by widening the operands (a bf16 x bf16
    product is exact in f32)."""
    if x.dtype == torch.float32:
        return torch.matmul(x, lm_head)
    if x.is_cuda:
        return torch.mm(x, lm_head, out_dtype=torch.float32)
    return torch.matmul(x.float(), lm_head.float())


DECODE_MODES = ("psum", "ar", "gemm_ar", "fused", "persistent")


class Qwen3(nn.Module):
    """Qwen3 decoder; runs on ``device`` (CUDA unless the caller asks for
    ``"cpu"``), or on ``mesh``'s device and ranks.  ``decode_mode``: "psum"
    (the per-kernel decode chain), "ar" or "gemm_ar" (the AllReduce
    kernels at tp > 1), or "fused" (the attention megakernel on a paged
    cache at tp = 1; a contiguous cache keeps the per-kernel attention, as in
    the JAX model)."""

    def __init__(self, config: ModelConfig, *, device=None,
                 decode_mode: str = "psum", mesh: Mesh | None = None,
                 axis: str = TP_AXIS):
        super().__init__()
        if decode_mode not in DECODE_MODES:
            raise ValueError(f"decode_mode {decode_mode!r} not in {DECODE_MODES}")
        if config.moe_strategy not in ("tp", "ep"):
            raise ValueError(f"moe_strategy {config.moe_strategy!r} not in ('tp', 'ep')")
        self.tp = 1 if mesh is None else mesh.shape[axis]
        if mesh is not None:
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's {mesh.device}")
            device = mesh.device
        if self.tp > 1:
            self._check_tp(config, mesh, decode_mode)
        # every MoE layer's MLP, over the mesh's ranks under EP
        self.moe = (MoEMLP(num_experts=config.num_experts, top_k=config.top_k,
                           swiglu=True, renormalize=config.norm_topk,
                           fp8_wire=config.moe_fp8_wire,
                           mesh=mesh if self.tp > 1 else None, axis=axis)
                    if config.is_moe else None)
        self.config = config
        self.device = resolve_device(device)
        self.decode_mode = decode_mode
        self.mesh, self.axis = (mesh, axis) if self.tp > 1 else (None, axis)
        # the heads of one rank
        self.heads = config.num_heads // self.tp
        self.kv_heads = config.num_kv_heads // self.tp

    def _check_tp(self, c: ModelConfig, mesh: Mesh, decode_mode: str) -> None:
        n = self.tp
        if c.is_moe and c.moe_strategy != "ep":
            raise NotImplementedError(
                "MoE under moe_strategy 'tp' at tp > 1 (the experts' AllGather and "
                "ReduceScatter around the grouped GEMM: ROADMAP A7) is not ported; "
                "moe_strategy 'ep' serves MoE at tp > 1")
        if len(mesh.axes) != 1:
            raise NotImplementedError(
                f"mesh {mesh.shape}: the model runs on a mesh of one axis, its tp axis")
        sizes = [("num_heads", c.num_heads), ("num_kv_heads", c.num_kv_heads)]
        sizes.append(("num_experts", c.num_experts) if c.is_moe
                     else ("intermediate", c.intermediate))
        for what, size in sizes:
            if size % n:
                raise ValueError(f"{what} = {size} does not divide among tp = {n} ranks")

    # -- parameters -------------------------------------------------------

    def init(self, generator: torch.Generator | None = None,
             scale: float = 0.02) -> QwenParams:
        """Random N(0, ``scale``) weights and unit norms, drawn from
        ``generator`` (a generator on this model's device; seed 0 when
        None).  At tp > 1 each layer is drawn as at tp = 1, then sharded
        (:meth:`shard_layer`)."""
        c = self.config
        dev = self.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        layers = []
        for _ in range(c.num_layers):
            attn = init_attn(generator, c.hidden, c.num_heads, c.num_kv_heads,
                             c.head_dim, qk_norm=c.qk_norm, dtype=c.dtype,
                             scale=scale, device=dev)
            if c.is_moe:
                # the tp = 1 draw (the TP layout at one rank)
                mlp = dataclasses.replace(self.moe, mesh=None).init(
                    generator, c.hidden, c.moe_intermediate, dtype=c.dtype, scale=scale,
                    device=dev)
            else:
                mlp = init_mlp(generator, c.hidden, c.intermediate,
                               dtype=c.dtype, scale=scale, device=dev)
            # then each rank's shard: the same weights at every tp from one seed
            layers.append(self.shard_layer(QwenLayerParams(
                ln1=torch.ones((c.hidden,), dtype=c.dtype, device=dev),
                attn=attn,
                ln2=torch.ones((c.hidden,), dtype=c.dtype, device=dev),
                mlp=mlp,
            )))
        embed = torch.randn((c.vocab, c.hidden), generator=generator,
                            dtype=c.dtype, device=dev) * scale
        lm_head = torch.randn((c.hidden, c.vocab), generator=generator,
                              dtype=c.dtype, device=dev) * scale
        return QwenParams(embed=embed, layers=layers,
                          final_norm=torch.ones((c.hidden,), dtype=c.dtype,
                                                device=dev),
                          lm_head=lm_head)

    def shard_layer(self, lp: QwenLayerParams) -> QwenLayerParams:
        """A layer's tp = 1 parameters in this model's layout: at tp > 1 the
        attention rank-stacked (a copy) and the dense MLP's shards; a MoE
        layer keeps its tensors (under EP rank r's experts are their rows
        ``[r E/n, (r + 1) E/n)``; the TP strategy is served at tp = 1
        only)."""
        c, n = self.config, self.tp
        mlp = lp.mlp
        if n > 1 and not c.is_moe:
            mlp = shard_mlp(mlp, n)
        attn = lp.attn
        if n > 1:
            attn = shard_attn(attn, n, c.num_heads, c.num_kv_heads, c.head_dim)
        return dataclasses.replace(lp, attn=attn, mlp=mlp)

    def shard_params(self, params: QwenParams) -> QwenParams:
        """tp = 1 parameters (``Qwen3(config).init``, or the TP-strategy
        draw of a MoE config) in this model's layout (:meth:`shard_layer`);
        the embedding, the norms and the lm_head stay the same tensors."""
        return dataclasses.replace(params, layers=[self.shard_layer(lp) for lp in params.layers])

    # -- shared pieces ----------------------------------------------------

    def _heads(self, p: TPAttnParams, qkv: torch.Tensor, s: int):
        """A ``[q | k | v]`` projection of (B' * S) rows -> q (B', H, S, D),
        k/v (B', Hkv, S, D), QK-normed; the heads are one rank's, B' folds
        the ranks into the batch at tp > 1."""
        c = self.config
        q, k, v = split_heads(qkv, s, self.heads, self.kv_heads, c.head_dim)
        if c.qk_norm:
            q = rms_norm(q, p.q_norm, c.rms_eps)
            k = rms_norm(k, p.k_norm, c.rms_eps)
        return q, k, v

    def _project_qkv(self, p: TPAttnParams, x: torch.Tensor, b: int, s: int):
        """(B*S, K) -> q (B', H, S, D), k/v (B', Hkv, S, D), QK-normed, from
        the ``[q | k | v]`` columns of ``wqkv``: each rank's, B' = tp B."""
        return self._heads(p, tp_mlp.replicated_column_gemm(x, p.wqkv), s)

    def _finish(self, params: QwenParams, x: torch.Tensor) -> torch.Tensor:
        return logits_f32(rms_norm(x, params.final_norm, self.config.rms_eps),
                          params.lm_head)

    # -- prefill ----------------------------------------------------------

    @torch.no_grad()
    def prefill(self, params: QwenParams, cache, input_ids: torch.Tensor,
                true_len: torch.Tensor | int | None = None):
        """Forward all prompt tokens and fill the cache.  ``input_ids``:
        (B, S).  Returns (f32 logits (B, S, V), cache) with the cache length
        set to S, or to ``true_len`` (``qwen.py:311-350``): the real prompt
        length when ``input_ids`` is right-padded to a bucket
        (``Engine.precompile``), an int or a device scalar.  Attention is
        causal, so the pads change no logit before ``true_len``, and the
        length masks the K/V they wrote: the next decode step overwrites
        position ``true_len``."""
        if self.tp > 1:
            return self._prefill_tp(params, cache, input_ids, true_len)
        c = self.config
        b, s = input_ids.shape
        x = params.embed[input_ids.reshape(-1).to(self.device)]
        cos, sin = rope_freqs(torch.arange(s, device=self.device), c.head_dim,
                              theta=c.rope_theta)
        for li, lp in enumerate(params.layers):
            q, k, v = self._project_qkv(lp.attn, rms_norm(x, lp.ln1, c.rms_eps),
                                        b, s)
            q = apply_rope(q, cos, sin).contiguous()
            k = apply_rope(k, cos, sin).contiguous()
            v = v.contiguous()
            if isinstance(cache, PagedKVCache):
                write_prefill_paged(cache, li, k, v)
            else:
                write_prefill(cache, li, k, v)
            out = flash_attention(q, k, v, causal=True)
            out = out.transpose(1, 2).reshape(b * s, c.num_heads * c.head_dim)
            x = x + torch.matmul(out, lp.attn.wo)
            x = x + self._mlp_forward(lp.mlp, rms_norm(x, lp.ln2, c.rms_eps))
        logits = self._finish(params, x)
        return logits.reshape(b, s, c.vocab), with_length(cache, s if true_len is None else true_len)

    def _prefill_tp(self, params: QwenParams, cache, input_ids: torch.Tensor, true_len=None):
        """Prefill at tp = n (``qwen.py:273-309, 322-351``): the B S rows
        row-sharded over the ranks; per layer AG-GEMM (qkv), the ranks'
        qk-norm, RoPE and flash attention in one launch over the rank-folded
        batch, the K/V into the head-sharded cache, GEMM-RS (o); then the
        MLP's AG-GEMM, SwiGLU, GEMM-RS.  The logits from the gathered rows."""
        c, n, mesh = self.config, self.tp, self.mesh
        b, s = input_ids.shape
        if (b * s) % n:
            raise ValueError(f"B * S = {b * s} rows do not divide among tp = {n} ranks")
        x = shard(mesh, params.embed[input_ids.reshape(-1).to(self.device)], self.axis)
        cos, sin = rope_freqs(torch.arange(s, device=self.device), c.head_dim,
                              theta=c.rope_theta)
        for li, lp in enumerate(params.layers):
            qkv = ag_gemm(rms_norm(x, lp.ln1, c.rms_eps), lp.attn.wqkv, mesh, self.axis)
            q, k, v = self._heads(lp.attn, qkv, s)              # (n B, heads, S, D)
            q = apply_rope(q, cos, sin).contiguous()
            k = apply_rope(k, cos, sin).contiguous()
            v = v.contiguous()
            if isinstance(cache, PagedKVCache):
                write_prefill_paged(cache, li, k, v)
            else:
                write_prefill(cache, li, k, v)
            out = flash_attention(q, k, v, causal=True)
            out = out.transpose(1, 2).reshape(n, b * s, self.heads * c.head_dim)
            x = x + gemm_rs(out, lp.attn.wo, mesh, self.axis)
            x = x + self._mlp_forward(lp.mlp, rms_norm(x, lp.ln2, c.rms_eps))
        logits = self._finish(params, unshard(mesh, x, self.axis))
        return logits.reshape(b, s, c.vocab), with_length(cache, s if true_len is None else true_len)

    # -- decode -----------------------------------------------------------

    def _attn_decode(self, p: TPAttnParams, x: torch.Tensor, cache,
                     layer: int, cos, sin, lens) -> torch.Tensor:
        """The per-kernel attention step (``qwen.py:474-626``): qkv product,
        qk-norm, RoPE, the token's append (requantizing its page on an int8
        cache), then the decode kernel over the cache including the token
        (``lens``: the step's lengths after the append, made once a step).
        At tp > 1 the ranks' heads attend as one rank-folded batch against the
        head-sharded cache.  Returns the o-proj output (B, K)."""
        b = x.shape[0]
        q, k, v = self._project_qkv(p, x, b, 1)
        q = apply_rope(q, cos, sin)[:, :, 0].contiguous()   # (B, H, D)
        k = apply_rope(k, cos, sin)[:, :, 0]
        append_token(cache, layer, k, v[:, :, 0])
        if isinstance(cache, PagedKVCache):
            out = paged_decode_attention(q, cache.k[layer], cache.v[layer],
                                         cache.block_table, lens,
                                         **layer_scales(cache, layer))
        else:
            out = decode_attention(q, cache.k[layer], cache.v[layer], lens)
        if self.tp > 1:
            return self._row_parallel_reduce(out.reshape(self.tp, b, -1), p.wo)
        return self._row_parallel_reduce(out.reshape(b, -1), p.wo)

    def _attn_decode_paged_fused(self, p: TPAttnParams, x: torch.Tensor,
                                 cache: PagedKVCache, layer: int) -> torch.Tensor:
        """The attention megakernel step (``qwen.py:628-693``): one launch
        per layer projects, normalizes, rotates, appends and attends, for
        every rank at tp > 1 (the rank-stacked wqkv, the folded cache).  On
        an int8 cache the kernel returns the token, which the exact
        requantizing append then writes (``append_layer_quantized``)."""
        c = self.config
        res = fused_attn_decode(
            x, p.wqkv, p.q_norm, p.k_norm, cache.k[layer], cache.v[layer],
            cache.block_table, cache.seq_lens, rope_theta=c.rope_theta,
            qk_eps=c.rms_eps if c.qk_norm else None, **layer_scales(cache, layer))
        if cache.quantized:
            _, _, _, k_tok, v_tok = res
            append_layer_quantized(cache.k[layer], cache.v[layer],
                                   cache.k_scale[layer], cache.v_scale[layer],
                                   cache.block_table, cache.seq_lens,
                                   k_tok, v_tok)
        return self._row_parallel_reduce(res[0], p.wo)

    def _k15_serves(self, n_dim: int) -> bool:
        """Whether the fused modes' reduction runs on K15 at tp > 1 (JAX
        ``qwen.py:157-163``, ``:697-702``: F and N divide by tp; F does by
        the rank-stacked layout); else the "psum" path, as JAX's other
        shapes.  Widths K15 does not take raise in its wrapper."""
        return self.decode_mode in ("fused", "persistent") and n_dim % self.tp == 0

    def _row_parallel_reduce(self, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """A decode step's ``AllReduce(h @ w)`` (``qwen.py:152-190``).  At
        tp = 1 the fused modes' GEMM + AllReduce entry, else the product.
        At tp = n, ``h`` (n, B, F / n) and ``w`` (n, F / n, K) rank-stacked,
        the result (B, K) replicated: "fused" and "persistent" on K15,
        "gemm_ar" on K14 when B divides by n, "ar" (and "gemm_ar" otherwise)
        the ranks' partials in h's dtype on K11, "psum" the sum of their f32
        partials rounded once."""
        n = self.tp
        if n == 1:
            if self.decode_mode in ("fused", "persistent"):
                return fused_linear_ar(h, w)
            return torch.matmul(h, w)
        if self._k15_serves(w.shape[2]):
            return fused_linear_ar(h, w, self.mesh, self.axis)
        if self.decode_mode == "gemm_ar" and h.shape[1] % n == 0:
            return gemm_ar(h, w, self.mesh, self.axis)[0]
        if self.decode_mode in ("ar", "gemm_ar"):
            return all_reduce(torch.matmul(h, w), self.mesh, self.axis)[0]
        return batched_product(h, w, torch.float32).sum(0).to(h.dtype)

    def _mlp_forward(self, p, x: torch.Tensor) -> torch.Tensor:
        """The prefill MLP (``qwen.py:211-221``): the dense SwiGLU (at tp > 1
        between K12 and K13), or the routed experts by ``moe_strategy``
        (under EP on the row-sharded stream (n, B S / n, K))."""
        c = self.config
        if c.is_moe:
            if c.moe_strategy == "ep":
                return self.moe.forward_ep(p, x)
            return self.moe.forward_tp(p, x)
        if self.tp > 1:
            return tp_mlp.forward(p, x, self.mesh, self.axis)
        return mlp_forward(p, x)

    def _mlp_decode(self, p, x: torch.Tensor) -> torch.Tensor:
        """A decode step's MLP and its AllReduce (``qwen.py:223-231``,
        ``:695-734``): the routed experts on the replicated batch in every
        mode, by ``moe_strategy``; else as :meth:`_row_parallel_reduce`
        dispatches."""
        if self.config.is_moe:
            if self.config.moe_strategy == "ep":
                return self.moe.forward_replicated_ep(p, x)
            return self.moe.forward_replicated(p, x)
        if self.tp > 1:
            if self._k15_serves(p.down.shape[2]):
                return fused_mlp_ar(x, p.gate_up, p.down, self.mesh, self.axis)
            if self.decode_mode == "gemm_ar" and x.shape[0] % self.tp == 0:
                return tp_mlp.forward_ar(p, x, self.mesh, self.axis)[0]
            # each rank's gate/up columns and SwiGLU, then the reduction
            h = tp_mlp.act_combine(tp_mlp.replicated_column_gemm(x, p.gate_up))
            return self._row_parallel_reduce(h, p.down)
        if self.decode_mode in ("fused", "persistent"):
            return fused_mlp_ar(x, p.gate_up, p.down)
        return mlp_forward(p, x)

    @torch.no_grad()
    def decode(self, params: QwenParams, cache, tokens: torch.Tensor, *,
               stacked: pd.StackedDecodeParams | None = None):
        """One decode step.  ``tokens``: (B,).  Each layer writes the new
        token's K/V at its position and attends over the cache up to and
        including it (``qwen.py:736-781``).  Returns (f32 logits (B, V),
        cache advanced by 1).  In "persistent" mode on a cache it serves,
        one launch of every layer, through ``stacked`` (the layer table;
        built for this call when None)."""
        if self.decode_mode == "persistent" and self._persistent_ok(cache):
            sp = stacked if stacked is not None else pd.stack_decode_params(params)
            return self._persistent_step(params, sp, cache, tokens)
        c = self.config
        paged = isinstance(cache, PagedKVCache)
        fused = paged and self.decode_mode in ("fused", "persistent")
        cos = sin = lens = None
        if not fused:
            if paged:
                # per-sequence ragged positions (qwen.py:558)
                pos = cache.seq_lens.to(torch.float32)[:, None, None]   # (B, 1, 1)
                lens = cache.seq_lens + 1
            else:
                # one shared position (qwen.py:481), read on the device
                pos = cache.kv_len.to(torch.float32).reshape(1)
                lens = cache.kv_len + 1
            cos, sin = rope_freqs(pos, c.head_dim, theta=c.rope_theta)
        x = params.embed[tokens.to(self.device)]
        for li, lp in enumerate(params.layers):
            h = rms_norm(x, lp.ln1, c.rms_eps)
            if fused:
                x = x + self._attn_decode_paged_fused(lp.attn, h, cache, li)
            else:
                x = x + self._attn_decode(lp.attn, h, cache, li, cos, sin, lens)
            x = x + self._mlp_decode(lp.mlp, rms_norm(x, lp.ln2, c.rms_eps))
        return self._finish(params, x), advance(cache, 1)

    # -- persistent decode ------------------------------------------------

    def _persistent_ok(self, cache) -> bool:
        """Whether the persistent kernel serves this cache (``qwen.py:785-796``):
        paged full-precision pools, a dense MLP, every sharded dim divisible
        by tp.  Anything else runs the "fused" chain."""
        c, n = self.config, self.tp
        return (isinstance(cache, PagedKVCache) and not cache.quantized and not c.is_moe
                and c.hidden % n == 0 and c.intermediate % n == 0
                and c.num_kv_heads % n == 0 and c.num_heads % n == 0)

    def _persistent_step(self, params: QwenParams, sp: pd.StackedDecodeParams,
                         cache: PagedKVCache, tokens: torch.Tensor):
        """Every layer of one step in one launch, then the final norm and
        the lm_head outside it (``qwen.py:798-817``); the pools are appended
        in place."""
        c = self.config
        x = params.embed[tokens.to(self.device)]
        x, _, _ = pd.persistent_decode_step(
            x, sp, cache.k, cache.v, cache.block_table, cache.seq_lens, self.mesh, self.axis,
            rope_theta=c.rope_theta, rms_eps=c.rms_eps,
            qk_eps=c.rms_eps if c.qk_norm else None)
        return self._finish(params, x), advance(cache, 1)

    @torch.no_grad()
    def decode_multi(self, params: QwenParams, cache, tokens: torch.Tensor,
                     steps: int, *, stacked: pd.StackedDecodeParams | None = None):
        """``steps`` greedy decode steps (``qwen.py:824-857``): each step's
        argmax is fed back as the next token on the device, so nothing is
        read back to the host inside the window.  In "persistent" mode the
        layer table (``stacked``, or built here) is made once, outside the
        loop.  Returns (tokens (steps, B) int32, cache)."""
        tok = tokens.to(device=self.device, dtype=torch.int32)
        if self.decode_mode == "persistent" and self._persistent_ok(cache):
            sp = stacked if stacked is not None else pd.stack_decode_params(params)
            return pd.decode_bundle(lambda ca, t: self._persistent_step(params, sp, ca, t),
                                    cache, tok, steps)
        return pd.decode_bundle(lambda ca, t: self.decode(params, ca, t), cache, tok, steps)
