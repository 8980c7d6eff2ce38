"""The decode megakernel path (``decode_mode="fused"``): counterpart of
``triton_distributed_tpu/ops/fused_decode.py`` at tp = 1.

- :func:`fused_attn_decode`: one layer's attention side of a decode step
  (qkv projection, qk-RMSNorm, RoPE, the ragged append of the new token's
  K/V into the paged pool, and block-table flash decode with the token
  folded in last) in one launch of ``csrc/fused_decode.cu`` (K4), which
  replaces the Pallas ``_fused_attn_kernel``.  Its plain version is
  :func:`fused_attn_decode_ref`; the wrapper takes it only for CPU tensors.
- :func:`fused_mlp_ar` / :func:`fused_linear_ar`: the MLP and the o-proj
  chained into an AllReduce ring.  At one rank the JAX functions are plain
  products (``:756-762``, ``:851-853``), and so are these; more ranks
  belong to the multi-GPU slice of the port.
"""

from __future__ import annotations

import functools

import torch

from ..core import build
from ..core.launches import count
from ..core.utils import cdiv
from ..layers.norm import rms_norm
from ..layers.tp_mlp import TPMLPParams, mlp_forward
from .attention import (
    KERNEL_DTYPES,
    _check_kernel_shape,
    _check_tensors,
    _ptr,
    _sm_count,
    _stream,
    check_int32,
    check_page_scales,
    decode_ref,
    decode_split_plan,
    gather_pages,
)
from .rope import apply_rope_at

PROJ_ROW_GRANULE = 64      # K rows a block's lane groups take per step


# ---------------------------------------------------------------------------
# plain version


def _split_qkv(x, wqkv, q_norm, k_norm, hk: int, d: int, positions,
               rope_theta: float, qk_eps):
    """q (B, H, D), k/v (B, Hkv, D) for one token per sequence at
    ``positions`` (B,): the f32 product rounded to x's dtype, then qk-RMSNorm
    and RoPE, each rounded back (JAX ``fused_decode.py:166-177``)."""
    b = x.shape[0]
    h = wqkv.shape[1] // d - 2 * hk
    qkv = torch.matmul(x.float(), wqkv.float()).to(x.dtype)
    q, k, v = qkv.split([h * d, hk * d, hk * d], dim=-1)
    q, k, v = q.reshape(b, h, d), k.reshape(b, hk, d), v.reshape(b, hk, d)
    if qk_eps is not None:
        q = rms_norm(q, q_norm, qk_eps)
        k = rms_norm(k, k_norm, qk_eps)
    pos = positions.to(x.device)[:, None]
    return (apply_rope_at(q, pos, theta=rope_theta),
            apply_rope_at(k, pos, theta=rope_theta), v)


def fused_attn_decode_ref(x, wqkv, q_norm, k_norm, pool_k, pool_v,
                          block_table, seq_lens, *, rope_theta: float = 10_000.0,
                          qk_eps: float | None = None,
                          sm_scale: float | None = None, soft_cap: float = 0.0,
                          k_scale=None, v_scale=None):
    """Plain version of :func:`fused_attn_decode`, with the same returns.
    Full-precision pools get the token written in place at its slot
    (the page clamped to the table, as the kernel does); the attention is
    one masked softmax over the cached prefix [0, pos) and the token."""
    p, hk, ps, d = pool_k.shape
    b, mp = block_table.shape
    sm_scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    quantized = k_scale is not None
    pos = seq_lens.long()
    q, k_new, v_new = _split_qkv(x, wqkv, q_norm, k_norm, hk, d, pos,
                                 rope_theta, qk_eps)
    if not quantized:
        pages = block_table.long().gather(
            1, torch.clamp(pos // ps, max=mp - 1)[:, None])[:, 0]
        pool_k[pages, :, pos % ps] = k_new.to(pool_k.dtype)
        pool_v[pages, :, pos % ps] = v_new.to(pool_v.dtype)
    kc, ks = gather_pages(pool_k, block_table, k_scale)
    vc, vs = gather_pages(pool_v, block_table, v_scale)
    k_all = torch.cat([kc.float(), k_new.float()[:, :, None]], dim=2)
    v_all = torch.cat([vc.float(), v_new.float()[:, :, None]], dim=2)
    keep = torch.cat([torch.arange(mp * ps, device=x.device)[None, :] < pos[:, None],
                      torch.ones((b, 1), dtype=torch.bool, device=x.device)], dim=1)
    if quantized:
        one = torch.ones((b, hk, 1), dtype=torch.float32, device=x.device)
        ks, vs = torch.cat([ks, one], dim=2), torch.cat([vs, one], dim=2)
    out = decode_ref(q, k_all, v_all, keep, sm_scale=sm_scale,
                     soft_cap=soft_cap, p_dtype=x.dtype, k_scale=ks,
                     v_scale=vs).reshape(b, -1)
    if quantized:
        return out, pool_k, pool_v, k_new, v_new
    return out, pool_k, pool_v


# ---------------------------------------------------------------------------
# K4


_sync_buffers: dict[tuple[str, int | None, int], torch.Tensor] = {}


def _sync_buffer(device, stream: int, n: int) -> torch.Tensor:
    """The kernel's work and ticket counters for launches on ``stream`` of
    ``device``: zero at rest, and the kernel leaves them zero.  Kept across
    calls, so the kernel costs no clearing launch.  Launches on one stream
    run in turn and share them; each stream has its own, since launches on
    two streams may run at once and would interleave their counters."""
    key = (device.type, device.index, stream)
    buf = _sync_buffers.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros((n,), dtype=torch.int32, device=device)
        _sync_buffers[key] = buf
    return buf


@functools.lru_cache(maxsize=None)
def _inv_freq(device, d: int, theta: float) -> torch.Tensor:
    """RoPE's (D / 2) f32 inverse frequencies, as ``ops.rope.rope_freqs``
    computes them, cached per device."""
    half = d // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (float(theta) ** exponent)


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(d: int, g: int, dtype: torch.dtype, quantized: bool) -> int:
    """How many K4 blocks of this instantiation an SM holds at once."""
    n = build.library().tdt_fused_attn_decode_blocks_per_sm(
        d, g, KERNEL_DTYPES[dtype], int(quantized))
    if n <= 0:
        raise RuntimeError(f"fused_attn_decode: no occupancy for D={d} G={g} "
                           f"{dtype} int8={quantized} ({n})")
    return n


def fused_plan(b: int, k_dim: int, hk: int, g: int, capacity: int,
               page_size: int, device, blocks_per_sm: int
               ) -> tuple[int, int, int, int]:
    """(n_kslice, k_chunk, n_split, chunk): the projection cuts wqkv's K rows
    into ``n_kslice`` slices of ``k_chunk`` so that the Hkv * (G + 2) column
    tiles make one full wave of ``blocks_per_sm`` blocks on every SM; the
    attention cuts the prefix as the decode kernels do."""
    tiles = hk * (g + 2)
    want = max(1, blocks_per_sm * _sm_count(device.index) // tiles)
    n = max(1, min(want, cdiv(k_dim, PROJ_ROW_GRANULE)))
    k_chunk = cdiv(cdiv(k_dim, n), PROJ_ROW_GRANULE) * PROJ_ROW_GRANULE
    n_split, chunk = decode_split_plan(b * hk, capacity, device,
                                       granule=page_size)
    return cdiv(k_dim, k_chunk), k_chunk, n_split, chunk


def fused_attn_decode(x: torch.Tensor, wqkv: torch.Tensor,
                      q_norm: torch.Tensor | None, k_norm: torch.Tensor | None,
                      pool_k: torch.Tensor, pool_v: torch.Tensor,
                      block_table: torch.Tensor, seq_lens: torch.Tensor, *,
                      rope_theta: float = 10_000.0, qk_eps: float | None = None,
                      sm_scale: float | None = None, soft_cap: float = 0.0,
                      k_scale: torch.Tensor | None = None,
                      v_scale: torch.Tensor | None = None):
    """One layer's fused attention-side decode step.

    ``x``: (B, K) activations; ``wqkv``: (K, (Hq + 2 Hkv) D) with columns
    ``[q | k | v]``; ``q_norm``/``k_norm``: (D,) used when ``qk_eps`` is
    given; ``pool_k``/``pool_v``: (P, Hkv, page_size, D); ``block_table``:
    (B, max_pages) int32; ``seq_lens``: (B,) int32, the new token's
    position.  Returns ``(out, pool_k, pool_v)``: out (B, Hq D) attention
    outputs before the o-proj, the pools updated in place with the new
    token at each sequence's position.

    int8 pools (``k_scale``/``v_scale`` (P, Hkv) f32): the pages are
    dequantized as they stream and nothing is appended; the return is
    ``(out, pool_k, pool_v, k_tok, v_tok)`` with the new token's k/v
    (B, Hkv, D) in x's dtype, for ``kv_cache.append_layer_quantized``.
    This step's attention already holds the token, in full precision."""
    b, k_dim = x.shape
    p, hk, ps, d = pool_k.shape
    if pool_v.shape != pool_k.shape:
        raise ValueError(f"pool shape mismatch: {tuple(pool_k.shape)} vs "
                         f"{tuple(pool_v.shape)}")
    qkv_cols = wqkv.shape[1]
    if wqkv.dim() != 2 or wqkv.shape[0] != k_dim or qkv_cols % d:
        raise ValueError(f"wqkv {tuple(wqkv.shape)} inconsistent with x "
                         f"{tuple(x.shape)} / head_dim {d}")
    h = qkv_cols // d - 2 * hk
    if h < hk or h % hk:
        raise ValueError(f"wqkv {tuple(wqkv.shape)} does not hold [q|k|v] for "
                         f"{hk} kv heads at head_dim {d}")
    mp = block_table.shape[1]
    if block_table.dim() != 2 or block_table.shape[0] != b \
            or tuple(seq_lens.shape) != (b,):
        raise ValueError(f"block_table {tuple(block_table.shape)} / seq_lens "
                         f"{tuple(seq_lens.shape)} inconsistent with B={b}")
    quantized = check_page_scales(pool_k, pool_v, k_scale, v_scale)
    norms = (q_norm, k_norm) if qk_eps is not None else ()
    if any(n is None for n in norms):
        raise ValueError("qk_eps needs q_norm and k_norm")
    _check_tensors(("x", "wqkv") + ("q_norm", "k_norm")[:len(norms)],
                   (x, wqkv, *norms))
    _check_tensors(("x", "pool_k", "pool_v", "block_table", "seq_lens"),
                   (x, pool_k, pool_v, block_table, seq_lens), float_like=False)
    if not quantized and pool_k.dtype != x.dtype:
        raise TypeError(f"pools of dtype {pool_k.dtype} with x {x.dtype}: "
                        "full-precision pools hold x's dtype")
    sm_scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    if x.device.type == "cpu":
        return fused_attn_decode_ref(
            x, wqkv, q_norm, k_norm, pool_k, pool_v, block_table, seq_lens,
            rope_theta=rope_theta, qk_eps=qk_eps, sm_scale=sm_scale,
            soft_cap=soft_cap, k_scale=k_scale, v_scale=v_scale)
    g = h // hk
    _check_kernel_shape(d, g)
    check_int32(block_table=block_table, seq_lens=seq_lens)
    dev = x.device
    n_kslice, k_chunk, n_split, chunk = fused_plan(
        b, k_dim, hk, g, mp * ps, ps, dev,
        _blocks_per_sm(d, g, x.dtype, quantized))
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((b, h * d), dtype=x.dtype, device=dev)
    q_buf = torch.empty((b, h, d), dtype=x.dtype, device=dev)
    k_tok = torch.empty((b, hk, d), dtype=x.dtype, device=dev)
    v_tok = torch.empty_like(k_tok)
    part_proj = torch.empty((n_kslice * b * qkv_cols,), **f32)
    part_acc = torch.empty((b * hk * n_split * g * d,), **f32)
    part_ml = torch.empty((b * hk * n_split * g * 2,), **f32)
    stream = _stream(dev)
    sync = _sync_buffer(dev, stream, 2 + hk * (g + 2) + 2 * hk + b * hk)
    qn_, kn_ = norms if norms else (None, None)
    lib = build.library()
    err = lib.tdt_fused_attn_decode(
        x.data_ptr(), wqkv.data_ptr(), _ptr(qn_), _ptr(kn_), pool_k.data_ptr(),
        pool_v.data_ptr(), _ptr(k_scale), _ptr(v_scale), block_table.data_ptr(),
        seq_lens.data_ptr(), _inv_freq(dev, d, float(rope_theta)).data_ptr(),
        out.data_ptr(),
        q_buf.data_ptr(), k_tok.data_ptr(), v_tok.data_ptr(),
        part_proj.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        sync.data_ptr(), b, k_dim, h, hk, d, ps, mp, n_kslice, k_chunk,
        n_split, chunk, sm_scale, float(soft_cap),
        float(qk_eps) if qk_eps is not None else 0.0, KERNEL_DTYPES[x.dtype],
        stream)
    name = "fused_attn_decode_int8" if quantized else "fused_attn_decode"
    build.check(err, name)
    count(name)
    if quantized:
        return out, pool_k, pool_v, k_tok, v_tok
    return out, pool_k, pool_v


# ---------------------------------------------------------------------------
# the MLP and o-proj reductions, one rank


def _one_rank(world_size: int, name: str) -> None:
    if world_size != 1:
        raise NotImplementedError(
            f"{name} over {world_size} ranks (the fused GEMM + AllReduce ring) "
            "belongs to the multi-GPU slice of the port")


def fused_mlp_ar(x: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor,
                 world_size: int = 1) -> torch.Tensor:
    """The SwiGLU MLP of (B, K) ``x`` (``gate_up`` (K, 2F) as
    ``[gate | up]``, ``down`` (F, K)) and its AllReduce; at one rank the MLP
    alone (JAX ``fused_decode.py:756-762``)."""
    _one_rank(world_size, "fused_mlp_ar")
    return mlp_forward(TPMLPParams(gate_up=gate_up, down=down), x)


def fused_linear_ar(h: torch.Tensor, w: torch.Tensor,
                    world_size: int = 1) -> torch.Tensor:
    """``AllReduce(h @ w)``; at one rank the product (JAX
    ``fused_decode.py:851-853``)."""
    _one_rank(world_size, "fused_linear_ar")
    return torch.matmul(h, w)
