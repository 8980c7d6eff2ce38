"""The decode megakernel path (``decode_mode="fused"``): counterpart of
``triton_distributed_tpu/ops/fused_decode.py``.

- :func:`fused_attn_decode`: one layer's attention side of a decode step
  (qkv projection, qk-RMSNorm, RoPE, the ragged append of the new token's
  K/V into the paged pool, and block-table flash decode with the token
  folded in last) in one launch of ``csrc/fused_decode.cu`` (K4), which
  replaces the Pallas ``_fused_attn_kernel``.  At tp = n co-located ranks
  (a rank-stacked ``wqkv``) one launch serves every rank, the rank folded
  into the batch as the caches fold it.  Its plain version is
  :func:`fused_attn_decode_ref` (per rank); the wrapper takes it only for
  CPU tensors.
- :func:`fused_mlp_ar` / :func:`fused_linear_ar`: the MLP (gate/up product,
  SwiGLU, down projection) and the o-projection followed by the AllReduce
  of the ranks' partials, on rank-stacked operands: one cooperative launch
  of ``csrc/fused_ar.cu`` (K15) over every rank, which replaces the Pallas
  ``_fused_mlp_ar_kernel`` (``:507``).  The reduction's form follows K11's
  size rule (``comm/allreduce.py::choose_method`` on the (B, N) partial's
  bytes, :func:`ar_method`): at decode sizes the one-shot form (the whole
  product in one pass over the weight, then the push into every rank's
  slot and the slot-order f32 sum, :func:`oneshot_program`), above the
  threshold JAX's column-chunked GEMM + two-shot AllReduce ring
  (:func:`ar_program`, on ``comm/ring.py::chunk_ar_phase``).  Their plain
  versions walk the chosen schedule.  K14 (``ops/gemm_ar.py``) launches the
  one-shot linear form at decode sizes.  Without a mesh, or at one rank,
  the JAX functions are plain products (``:756-762``, ``:851-853``), and so
  are these.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..comm import ring
from ..comm.allreduce import _CODES, AllReduceMethod, choose_method, one_shot_program
from ..comm.launch import GEMM_DTYPES, check_config, walk_teams
from ..core import build, symm
from ..core.launches import count
from ..core.mesh import TP_AXIS, Mesh
from ..core.utils import cdiv
from ..lang import primitives as dl
from ..lang.primitives import Matmul, Swiglu, Team
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
    attention cuts the prefix as the decode kernels do.  A rank-folded
    launch takes the plan of one rank, so that each rank's arithmetic is
    that of its own tp = 1 launch."""
    tiles = hk * (g + 2)
    want = max(1, blocks_per_sm * _sm_count(device.index) // tiles)
    n = max(1, min(want, cdiv(k_dim, PROJ_ROW_GRANULE)))
    k_chunk = cdiv(cdiv(k_dim, n), PROJ_ROW_GRANULE) * PROJ_ROW_GRANULE
    n_split, chunk = decode_split_plan(b * hk, capacity, device,
                                       granule=page_size)
    return cdiv(k_dim, k_chunk), k_chunk, n_split, chunk


def _fused_attn_folded_ref(x, wqkv, q_norm, k_norm, pool_k, pool_v, block_table,
                           seq_lens, **kw):
    """The plain version at tp = n: rank r's tp = 1 step on its rows of the
    folded table and lengths, the pools shared (each rank's pages are its
    own); outputs stacked by rank."""
    n, b = wqkv.shape[0], x.shape[0]
    out = torch.stack([fused_attn_decode_ref(x, wqkv[r], q_norm, k_norm, pool_k, pool_v,
                                             block_table[r * b:(r + 1) * b],
                                             seq_lens[r * b:(r + 1) * b], **kw)[0]
                       for r in range(n)])
    return out, pool_k, pool_v


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

    At tp = n co-located ranks ``wqkv`` is rank-stacked (n, K, (Hq + 2 Hkv)
    D) with each rank's heads, x stays one replicated (B, K) copy, and the
    pools, table (n B, max_pages) and lengths (n B,) are the rank-folded
    ones of ``models/kv_cache.py`` (rank r's sequences at [r B, (r + 1)
    B)); out is (n, B, Hq D), rank-stacked.  One launch serves every rank.
    int8 pages are served at tp = 1 only.

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
    n_ranks = wqkv.shape[0] if wqkv.dim() == 3 else 1
    qkv_cols = wqkv.shape[-1]
    if wqkv.dim() not in (2, 3) or wqkv.shape[-2] != k_dim or qkv_cols % d:
        raise ValueError(f"wqkv {tuple(wqkv.shape)} inconsistent with x "
                         f"{tuple(x.shape)} / head_dim {d}")
    h = qkv_cols // d - 2 * hk
    if h < hk or h % hk:
        raise ValueError(f"wqkv {tuple(wqkv.shape)} does not hold [q|k|v] for "
                         f"{hk} kv heads at head_dim {d}")
    mp = block_table.shape[1]
    if block_table.dim() != 2 or block_table.shape[0] != n_ranks * b \
            or tuple(seq_lens.shape) != (n_ranks * b,):
        raise ValueError(f"block_table {tuple(block_table.shape)} / seq_lens "
                         f"{tuple(seq_lens.shape)} inconsistent with {n_ranks} rank(s) "
                         f"of B={b}")
    quantized = check_page_scales(pool_k, pool_v, k_scale, v_scale)
    if quantized and wqkv.dim() == 3:
        raise NotImplementedError("int8 pages at tp > 1 are not served; int8 pages serve tp = 1")
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
        kw = dict(rope_theta=rope_theta, qk_eps=qk_eps, sm_scale=sm_scale, soft_cap=soft_cap)
        if wqkv.dim() == 3:
            return _fused_attn_folded_ref(x, wqkv, q_norm, k_norm, pool_k, pool_v,
                                          block_table, seq_lens, **kw)
        return fused_attn_decode_ref(x, wqkv, q_norm, k_norm, pool_k, pool_v, block_table,
                                     seq_lens, k_scale=k_scale, v_scale=v_scale, **kw)
    g = h // hk
    _check_kernel_shape(d, g)
    check_int32(block_table=block_table, seq_lens=seq_lens)
    dev = x.device
    n_kslice, k_chunk, n_split, chunk = fused_plan(
        b, k_dim, hk, g, mp * ps, ps, dev,
        _blocks_per_sm(d, g, x.dtype, quantized))
    f32 = dict(dtype=torch.float32, device=dev)
    nb = n_ranks * b
    out = torch.empty((nb, h * d), dtype=x.dtype, device=dev)
    q_buf = torch.empty((nb, h, d), dtype=x.dtype, device=dev)
    k_tok = torch.empty((nb, hk, d), dtype=x.dtype, device=dev)
    v_tok = torch.empty_like(k_tok)
    part_proj = torch.empty((n_ranks * n_kslice * b * qkv_cols,), **f32)
    part_acc = torch.empty((nb * hk * n_split * g * d,), **f32)
    part_ml = torch.empty((nb * hk * n_split * g * 2,), **f32)
    stream = _stream(dev)
    sync = _sync_buffer(dev, stream, 2 + n_ranks * (hk * (g + 2) + 2 * hk + b * hk))
    qn_, kn_ = norms if norms else (None, None)
    wqkv = wqkv.contiguous()
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
        n_ranks, stream)
    name = "fused_attn_decode_int8" if quantized else "fused_attn_decode"
    build.check(err, name)
    # a rank-folded launch is counted by its form as well
    count(name, (n_ranks, b, k_dim, h, hk, d) if n_ranks > 1 else None)
    if wqkv.dim() == 3:
        out = out.reshape(n_ranks, b, h * d)
    if quantized:
        return out, pool_k, pool_v, k_tok, v_tok
    return out, pool_k, pool_v


# ---------------------------------------------------------------------------
# K15: the MLP and the o-projection followed by the AllReduce


def ar_method(nbytes: int, n: int,
              method: AllReduceMethod = AllReduceMethod.AUTO) -> AllReduceMethod:
    """The reduction form of K15 (and of K14 at decode sizes) for partials
    of ``nbytes`` per rank: ``method`` unless AUTO, else K11's size rule
    (:func:`comm.allreduce.choose_method`).  ONE_SHOT is the one-shot form,
    TWO_SHOT the ring."""
    return choose_method(nbytes, n) if method == AllReduceMethod.AUTO else method


# the launch counters' name of each form
FORM_NAMES = {AllReduceMethod.ONE_SHOT: "one_shot", AllReduceMethod.TWO_SHOT: "ring"}


def _swiglu_prologue(src: tuple[str, int]) -> list:
    """x times the gate and the up columns, then SwiGLU into ("act", 0)."""
    return [Matmul(("g", 0), src, ("wg", 0)), Matmul(("u", 0), src, ("wu", 0)),
            Swiglu(("act", 0), ("g", 0), ("u", 0))]


def ar_program(team: Team, me: int, swiglu: bool) -> list:
    """The ring form: JAX ``_fused_mlp_ar_kernel``'s schedule
    (``fused_decode.py:507-580``): with ``swiglu`` the prologue (x times the
    gate and the up columns, SwiGLU) before the entry barrier; then one
    column-chunked AllReduce instance over the activations and the weight's
    column chunks, and the ACK drain."""
    prog = _swiglu_prologue(("x", 0)) if swiglu else []
    dl.collective_prologue(prog, team, me, neighbors_only=True)
    ring.chunk_ar_phase(prog, team, me, ("act" if swiglu else "x", 0), "out", armed=False)
    ring.rs_ack_drain(prog, team.size)
    return prog


def oneshot_program(team: Team, me: int, swiglu: bool) -> list:
    """The one-shot form: [the prologue,] the whole product of the
    activations ("a", or "act" after SwiGLU) and the weight ("w", 0) into
    product entry ("x", 0), rounded once, then K11's one-shot schedule on it
    (:func:`comm.allreduce.one_shot_program`: the push into slot ``me`` of
    every rank, the slot-order f32 sum into ("out", 0))."""
    prog = _swiglu_prologue(("a", 0)) if swiglu else []
    prog.append(Matmul(("x", 0), ("act" if swiglu else "a", 0), ("w", 0)))
    return prog + one_shot_program(team, me)


def _swiglu_program(team: Team, me: int) -> list:
    return ar_program(team, me, True)


def _linear_program(team: Team, me: int) -> list:
    return ar_program(team, me, False)


def _oneshot_swiglu_program(team: Team, me: int) -> list:
    return oneshot_program(team, me, True)


def _oneshot_linear_program(team: Team, me: int) -> list:
    return oneshot_program(team, me, False)


def _ar_buffers(x, w, out, n: int, out_dtype, gate_up=None):
    """``bufs_of`` of the ring's plain walk: the activations (one copy, or
    rank r's), the weight's column chunks, the gate/up blocks and SwiGLU
    entries (swiglu), fresh product entries and receive slots, every rank's
    reduced chunks (``out`` (n, n, B, cn))."""
    b, cn = out.shape[-2], out.shape[-1]
    f = w.shape[-2]

    def bufs_of(s):
        new = functools.partial(torch.empty, dtype=out_dtype, device=w.device)
        bufs = {"x": [x if gate_up is not None else x[s]],
                "w": list(w[s].split(cn, dim=1)), "out": list(out[s]),
                "mm": list(new((n, b, cn))), "recv": list(new((2, b, cn)))}
        if gate_up is not None:
            bufs.update(wg=[gate_up[s][:, :f]], wu=[gate_up[s][:, f:]],
                        g=[new((b, f))], u=[new((b, f))], act=[new((b, f))])
        return bufs

    return bufs_of


def _oneshot_buffers(x, w, out, mesh: Mesh, n: int, out_dtype, gate_up=None):
    """``bufs_of`` of the one-shot's plain walk, per mesh slot: the
    activations (one copy, or the slot's), its weight, the gate/up blocks
    and SwiGLU entries (swiglu), a fresh product entry and n receive slots,
    and the slot's copy of the result (``out`` (*mesh.sizes, B, N))."""
    b, cols = out.shape[-2], out.shape[-1]
    f = w.shape[-2]
    ws, outs = w.reshape(mesh.size, f, cols), out.reshape(mesh.size, b, cols)
    xs = x if gate_up is not None else x.reshape(mesh.size, b, f)
    gus = gate_up.reshape(mesh.size, *gate_up.shape[-2:]) if gate_up is not None else None

    def bufs_of(s):
        new = functools.partial(torch.empty, dtype=out_dtype, device=w.device)
        bufs = {"a": [xs if gate_up is not None else xs[s]], "w": [ws[s]], "out": [outs[s]],
                "x": [new((b, cols))], "slots": list(new((n, b, cols)))}
        if gate_up is not None:
            bufs.update(wg=[gus[s][:, :f]], wu=[gus[s][:, f:]],
                        g=[new((b, f))], u=[new((b, f))], act=[new((b, f))])
        return bufs

    return bufs_of


def _rows(out: torch.Tensor) -> torch.Tensor:
    """Rank 0's (n, B, cn) chunk-major reduced chunks as (B, n cn) rows
    (JAX ``_ar_chunks_to_rows``)."""
    return out[0].permute(1, 0, 2).reshape(out.shape[-2], -1)


def _walk_ring(swiglu: bool, x, gate_up, w, mesh: Mesh, axis: str, out_dtype):
    team = Team.of(mesh, axis)
    n = team.size
    b, cols = x.shape[-2], w.shape[-1]
    out = torch.empty((n, n, b, cols // n), dtype=out_dtype, device=w.device)
    walk_teams(_swiglu_program if swiglu else _linear_program, team,
               _ar_buffers(x, w, out, n, out_dtype, gate_up))
    return out


def walk_oneshot(swiglu: bool, x, gate_up, w, mesh: Mesh, axis: str, out_dtype) -> torch.Tensor:
    """The one-shot form's plain walk on rank-stacked operands (swiglu: x
    one (B, K) copy, gate_up (*mesh.sizes, K, 2F); linear: x (*mesh.sizes,
    B, F)) with w (*mesh.sizes, F, N).  Returns every rank's copy of the
    result, (*mesh.sizes, B, N)."""
    team = Team.of(mesh, axis)
    out = torch.empty((*mesh.sizes, x.shape[-2], w.shape[-1]), dtype=out_dtype, device=w.device)
    walk_teams(_oneshot_swiglu_program if swiglu else _oneshot_linear_program, team,
               _oneshot_buffers(x, w, out, mesh, team.size, out_dtype, gate_up))
    return out


def _walk_ar(swiglu: bool, x, gate_up, w, mesh: Mesh, axis: str, out_dtype,
             method: AllReduceMethod) -> torch.Tensor:
    """The plain walk of ``method``'s form; returns the (B, N) result."""
    if method == AllReduceMethod.ONE_SHOT:
        return walk_oneshot(swiglu, x, gate_up, w, mesh, axis, out_dtype)[0]
    return _rows(_walk_ring(swiglu, x, gate_up, w, mesh, axis, out_dtype))


def _out_bytes(b: int, cols: int, out_dtype) -> int:
    return b * cols * torch.empty((), dtype=out_dtype).element_size()


def fused_mlp_ar_ref(x: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor,
                     mesh: Mesh, axis: str = TP_AXIS, *, out_dtype=None,
                     method: AllReduceMethod = AllReduceMethod.AUTO) -> torch.Tensor:
    """Plain version of K15's swiglu form, on any device: the schedule of
    ``method``'s form (AUTO: :func:`ar_method`'s choice, the kernel's)
    walked on tensors (g and u rounded to ``out_dtype``, SwiGLU in f32
    rounded once, each product rounded; the one-shot's slot sum in f32
    rounded once, each ring hop added in f32 and rounded once).  Returns
    (B, N)."""
    out_dtype = out_dtype or x.dtype
    method = ar_method(_out_bytes(x.shape[-2], down.shape[-1], out_dtype), mesh.shape[axis],
                       method)
    return _walk_ar(True, x, gate_up, down, mesh, axis, out_dtype, method)


def fused_linear_ar_ref(h: torch.Tensor, w: torch.Tensor, mesh: Mesh, axis: str = TP_AXIS, *,
                        out_dtype=None,
                        method: AllReduceMethod = AllReduceMethod.AUTO) -> torch.Tensor:
    """Plain version of K15's linear form: ``AllReduce(h_r @ w_r)`` on the
    schedule of ``method``'s form (AUTO: the kernel's).  Returns (B, N)."""
    out_dtype = out_dtype or h.dtype
    method = ar_method(_out_bytes(h.shape[-2], w.shape[-1], out_dtype), mesh.shape[axis],
                       method)
    return _walk_ar(False, h, None, w, mesh, axis, out_dtype, method)


GEMV_TILE_COLS = 64   # csrc/fused_ar.cuh kTileCols
GEMV_ROW_GRANULE = 64
GEMV_STAGE_ROWS = 512  # csrc/fused_ar.cuh kStageRows


def gemv_plan(b: int, kd: int, cols: int, lanes: int,
              max_k_chunk: int | None = None) -> symm.Gemv:
    """A decode product's plan: about two (64-column tile, K slice) items
    for every lane of the rank, so that every lane streams weights and the
    lanes' shares differ by one item at most; with ``max_k_chunk`` (the
    one-shot form's staged items, ``GEMV_STAGE_ROWS``) K slices of at most
    that many rows."""
    tiles = cdiv(cols, GEMV_TILE_COLS)
    n = max(1, min(cdiv(2 * lanes, tiles), cdiv(kd, GEMV_ROW_GRANULE)))
    if max_k_chunk is not None:
        n = max(n, cdiv(kd, max_k_chunk))
    k_chunk = cdiv(cdiv(kd, n), GEMV_ROW_GRANULE) * GEMV_ROW_GRANULE
    return symm.Gemv(b, kd, cols, cdiv(kd, k_chunk), k_chunk)


@functools.lru_cache(maxsize=None)
def _fused_ar_lanes(dtype_code: int, out_code: int, swiglu: bool, method_code: int,
                    ranks: int) -> int:
    lanes = build.library().tdt_fused_ar_lanes(dtype_code, out_code, int(swiglu), method_code,
                                               ranks)
    if lanes <= 0:
        raise RuntimeError(f"fused_ar: no co-resident lanes for {ranks} ranks ({lanes})")
    return lanes


def _launch_ar(swiglu: bool, x, gate_up, w, mesh: Mesh, axis: str, out_dtype,
               method: AllReduceMethod, stall_rank: int = -1) -> torch.Tensor:
    """K15 over every rank of the mesh in ``method``'s form (ONE_SHOT or
    TWO_SHOT, the ring).  Returns the ring's (B, N) result, or every rank's
    copy of the one-shot's, (*mesh.sizes, B, N).  ``stall_rank`` (tests of
    the bounded waits): that rank credits none of its puts."""
    team = Team.of(mesh, axis)
    n = team.size
    one = method == AllReduceMethod.ONE_SHOT
    b, cols = x.shape[-2], w.shape[-1]
    f, k = w.shape[-2], x.shape[-1]
    cn = cols if one else cols // n      # the product's columns: all, or a chunk's
    dt, ot = symm.DTYPE_CODES[w.dtype], symm.DTYPE_CODES[out_dtype]
    lanes = _fused_ar_lanes(dt, ot, swiglu, _CODES[method], mesh.size)
    stage = GEMV_STAGE_ROWS if one else None   # the one-shot stages A's slices
    up = gemv_plan(b, k, 2 * f, lanes, stage) if swiglu else symm.Gemv()
    dn = gemv_plan(b, f, cn, lanes, stage)
    # the ring double-buffers its chunk products' partials
    part_elems = max(up.n_kslice * b * 2 * f, (1 if one else 2) * dn.n_kslice * b * cn)
    fam = "fused_ar"
    chunk = b * cn
    mm = symm.landing(mesh, axis, f"{fam}_mm", (1 if one else n, chunk), out_dtype).data
    if one:
        land = symm.landing(mesh, axis, f"{fam}_slots", (n, chunk), out_dtype)
        red = torch.empty((*mesh.sizes, b, cols), dtype=out_dtype, device=w.device)
        rows = None
    else:
        land = symm.landing(mesh, axis, fam, (2, chunk), out_dtype)
        red = symm.landing(mesh, axis, f"{fam}_out", (n, chunk), out_dtype).data
        rows = torch.empty((b, cols), dtype=out_dtype, device=w.device)
    part = symm.landing(mesh, axis, f"{fam}_part", (part_elems,), torch.float32).data
    act = symm.landing(mesh, axis, f"{fam}_act", (b * f,), out_dtype).data if swiglu else None
    coll = symm.coll_args(team, mesh, x=mm, out=red, land=land,
                          pad=symm.signal_pad(mesh, axis, fam), chunk_elems=chunk,
                          method=_CODES[method], stall_rank=stall_rank)
    coll.dtype, coll.out_dtype = dt, ot
    none = symm.peers(None)
    args = symm.FusedArArgs(
        coll, symm.peers([x.data_ptr()] * mesh.size) if swiglu else symm.peers(symm.slot_ptrs(x, mesh)),
        symm.peers(symm.slot_ptrs(gate_up, mesh)) if swiglu else none,
        symm.peers(symm.slot_ptrs(w, mesh)),
        symm.peers(symm.slot_ptrs(act, mesh)) if swiglu else none,
        symm.peers(symm.slot_ptrs(part, mesh)), rows.data_ptr() if rows is not None else None,
        k, f, cols, up, dn)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    build.check(build.library().tdt_fused_ar(ctypes.byref(args), int(swiglu), stream),
                "fused_ar")
    return red if one else rows


def _ar_operands(name: str, act, w, mesh: Mesh | None, axis: str, out_dtype, wire_dtype: str,
                 config, gate_up=None):
    """The checks JAX's fused_mlp_ar / fused_linear_ar make, on rank-stacked
    operands; returns n and the output dtype."""
    if wire_dtype != "bf16":
        raise NotImplementedError(
            f"{name}: wire_dtype={wire_dtype!r}: the quantized reductions (JAX "
            "comm/quantized.py, ROADMAP A5) are not ported; only the EP all-to-all ships the "
            "rows that B9's port (K18) packs; use 'bf16'")
    check_config(config)
    n = 1 if mesh is None else mesh.shape[axis]
    out_dtype = out_dtype or act.dtype
    if n == 1:
        return n, out_dtype
    if isinstance(axis, (tuple, list)) or len(mesh.axes) != 1:
        raise NotImplementedError(f"{name}: the co-located ranks run a mesh of one axis")
    k = act.shape[-1]
    if w.dim() != 3 or w.shape[0] != n or (gate_up is None and (
            act.dim() != 3 or act.shape[0] != n or w.shape[1] != k)):
        raise ValueError(f"{name}: operands {tuple(act.shape)} @ {tuple(w.shape)} are not "
                         f"rank-stacked on {n} ranks")
    if gate_up is not None and (act.dim() != 2 or tuple(gate_up.shape) != (n, k, 2 * w.shape[1])):
        raise ValueError(f"{name}: gate_up {tuple(gate_up.shape)} inconsistent with x "
                         f"{tuple(act.shape)} / down {tuple(w.shape)} on {n} ranks")
    if w.shape[2] % n:
        raise ValueError(f"{name}: N={w.shape[2]} must be divisible by {axis}={n}")
    if act.is_cuda and (w.shape[1] % 8 or (w.shape[2] // n) % 8 or k % 8):
        raise ValueError(f"{name}: F / n = {w.shape[1]}, N / n = {w.shape[2] // n} and K = {k} "
                         "must be multiples of 8 for K15 (16-byte rows)")
    if (w.dtype, out_dtype) not in GEMM_DTYPES or act.dtype != w.dtype or (
            gate_up is not None and gate_up.dtype != w.dtype):
        raise TypeError(f"{name}: operands {act.dtype}, {w.dtype} -> {out_dtype}: K15 takes "
                        f"{[(str(a)[6:], str(o)[6:]) for a, o in GEMM_DTYPES]}")
    for t in (act, w) if gate_up is None else (act, gate_up, w):
        if t.device != mesh.device:
            raise ValueError(f"{name}: operand on {t.device}, the mesh on {mesh.device}")
    return n, out_dtype


def _local_weight(w: torch.Tensor) -> torch.Tensor:
    return w[0] if w.dim() == 3 else w


def fused_mlp_ar(x: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor,
                 mesh: Mesh | None = None, axis: str = TP_AXIS, *, config=None,
                 out_dtype=None, wire_dtype: str = "bf16") -> torch.Tensor:
    """``AllReduce(swiglu(x @ gate_up) @ down)`` (JAX ``fused_decode.py:717``)
    in one launch of K15 over every rank.

    ``x``: (B, K) replicated, one copy; ``gate_up``: rank-stacked (n, K,
    2F / n), rank r's ``[gate_r | up_r]``; ``down``: (n, F / n, N).  Returns
    (B, N), every rank's sum.  The reduction's form is :func:`ar_method`'s
    choice for the (B, N) partial (the one-shot at decode sizes, else the
    ring).  Needs N % n == 0 (the ring's column chunks); on the card also
    F / n, N / n, K multiples of 8 (K15's 16-byte rows; the one-shot alone
    needs N, not N / n), else it raises; B is free.  Without a mesh or at one
    rank (2-D or one-rank weights) the plain MLP, as JAX's n == 1.  A wire
    other than "bf16" raises (the quantized reductions are ROADMAP A5)."""
    n, out_dtype = _ar_operands("fused_mlp_ar", x, down, mesh, axis, out_dtype, wire_dtype,
                                config, gate_up if mesh is not None and mesh.shape[axis] > 1
                                else None)
    if n == 1:
        p = TPMLPParams(gate_up=_local_weight(gate_up), down=_local_weight(down))
        out = mlp_forward(p, x)
        return out if out.dtype == out_dtype else out.to(out_dtype)
    if not x.is_cuda:
        return fused_mlp_ar_ref(x, gate_up, down, mesh, axis, out_dtype=out_dtype)
    method = ar_method(_out_bytes(x.shape[0], down.shape[2], out_dtype), n)
    out = _launch_ar(True, x.contiguous(), gate_up.contiguous(), down.contiguous(), mesh, axis,
                     out_dtype, method)
    count("fused_mlp_ar", (FORM_NAMES[method], n, x.shape[0], x.shape[1], down.shape[1],
                           down.shape[2]))
    return out[0] if method == AllReduceMethod.ONE_SHOT else out


def fused_linear_ar(h: torch.Tensor, w: torch.Tensor, mesh: Mesh | None = None,
                    axis: str = TP_AXIS, *, config=None, out_dtype=None) -> torch.Tensor:
    """``AllReduce(h @ w)`` (JAX ``fused_decode.py:828``, the decode
    o-projection) in one launch of K15 over every rank.  ``h``: rank-stacked
    (n, B, F / n); ``w``: (n, F / n, N).  Returns (B, N), in :func:`ar_method`'s
    form.  Needs N % n == 0; on the card also F / n, N / n multiples of 8,
    else it raises; B is free.  Without a mesh or at one rank the product."""
    n, out_dtype = _ar_operands("fused_linear_ar", h, w, mesh, axis, out_dtype, "bf16", config)
    if n == 1:
        hh = h[0] if h.dim() == 3 else h
        out = torch.matmul(hh, _local_weight(w))
        return out if out.dtype == out_dtype else out.to(out_dtype)
    if not h.is_cuda:
        return fused_linear_ar_ref(h, w, mesh, axis, out_dtype=out_dtype)
    method = ar_method(_out_bytes(h.shape[1], w.shape[2], out_dtype), n)
    out = _launch_ar(False, h.contiguous(), None, w.contiguous(), mesh, axis, out_dtype, method)
    count("fused_linear_ar", (FORM_NAMES[method], n, h.shape[1], h.shape[2], w.shape[2]))
    return out[0] if method == AllReduceMethod.ONE_SHOT else out
