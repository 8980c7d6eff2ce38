"""The persistent decode step (``decode_mode="persistent"``): every layer of a
dense Qwen3 decode step in one launch.

Counterpart of ``triton_distributed_tpu/ops/persistent_decode.py``.
:func:`persistent_decode_step` runs L layers, each RMSNorm, the attention
cell of K4 (qkv product, qk-RMSNorm, RoPE, the in-place append into layer
l's pages, block-table flash decode with the token folded in), the
o-projection's AllReduce instance, the residual, RMSNorm, the SwiGLU MLP's
AllReduce instance and the residual, for every rank of a mesh of co-located
ranks, in one cooperative launch of K16, which replaces the Pallas
``_persistent_decode_kernel`` (``:368``).  K16 has two forms.  The served
form (bf16, head dim 128, :func:`served_form`) is
``csrc/persistent_decode_v2.cu``: one stream of weight loads per thread over
every product of the step, the products cut stream-K into equal runs per
lane (:func:`stream_geometry`), the norms, SwiGLU, the residual and the
merges folded into the products, 4 rank-wide barriers a layer
(:func:`step_stages`), and each o and down tile reduced across ranks by one
device-scope one-shot exchange (``persistent_program(..., form="oneshot")``).
The f32 and head dim 64 forms are ``csrc/persistent_decode.cu``: K4's
stages between barriers and 2L instances of K15's ring, chained on one set
of flags (``comm/ring.py::chunk_ar_phase`` with ``armed``;
:func:`persistent_program` is the whole launch's schedule).  Embed, final
norm, lm_head and argmax stay outside, as in JAX's ``_persistent_step``.

Port decisions:

- :class:`StackedDecodeParams` is a layer table, not a stacked copy: JAX
  stacks the weights into (L, ...) arrays, which at Qwen3-8B would add
  13.9 GB.  Here a device tensor holds each layer's weight addresses (ln1,
  wqkv, q_norm, k_norm, wo, ln2, gate_up, down; the projections
  rank-stacked, read by K16 at a per-kind rank stride), built once by
  :func:`stack_decode_params`; the table keeps the parameters alive.
- The pools are the port's rank-folded ones (``models/kv_cache.py``): (L,
  n P, Hkv / n, ps, D), the table (n B, max_pages), the lengths (n B).
- :func:`reference_decode_step` is the plain version, on those pools.  By
  default its reductions take the ring's order and rounding (each rank's
  chunk product rounded, each hop added in f32 and rounded once: K15's
  plain versions), with ``order="oneshot"`` the served form's (each rank's
  partial rounded, the slots summed in f32 and rounded once), and its
  attention K4's (the scaled q and p rounded to x's dtype), so that on the
  card it stands within a stated limit of K16.
  ``order="jax"`` is JAX's ``reference_decode_step`` (one rounding per
  product, the attention in f32 over the pages with the token): the n == 1
  step on the CPU, as in JAX, and the form the tests hold to JAX's.
- n == 1 on the card launches K16 too (the same stages, no ring phases), so
  no plain version serves the card.
- ``config``: None only (the tuner's wiring is ROADMAP queue A item 5).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from ..comm import ring
from ..comm.allreduce import AllReduceMethod
from ..comm.launch import check_config
from ..core import build, symm
from ..core.launches import count
from ..core.mesh import TP_AXIS, Mesh, make_mesh
from ..core.utils import cdiv
from ..lang import primitives as dl
from ..lang.primitives import Matmul, Reduce, Swiglu, Team
from ..layers.norm import rms_norm
from .attention import KERNEL_DTYPES, KERNEL_GROUPS, KERNEL_HEAD_DIMS, check_int32
from .fused_decode import (_fused_attn_folded_ref, _inv_freq, fused_attn_decode_ref,
                           fused_linear_ar_ref, fused_mlp_ar_ref, gemv_plan)
from .rope import apply_rope_at

# K16's f32 and head dim 64 forms chain K15's ring instances (csrc/fused_ar.cuh
# ar_instance) whatever the partial's size, so their plain version walks the
# ring form; the served form (bf16, head dim 128) exchanges each o and down
# tile once, K15's one-shot form
RING = AllReduceMethod.TWO_SHOT
ONE_SHOT = AllReduceMethod.ONE_SHOT
# K16's served form (csrc/persistent_decode_v2.cu): query heads a kv head it is
# built for, the most rows of A, a product tile's output columns, the rows
# of a pass over a tile, and its products in the order a layer runs them
STREAM_GROUPS = (4,)
STREAM_MAX_B = 4
STREAM_TILE = 128
STREAM_ROWS = 16
STREAM_PRODUCTS = ("qkv", "o", "gate_up", "down")
ORDERS = {"ring": RING, "oneshot": ONE_SHOT}
LAYER_KINDS = ("ln1", "wqkv", "q_norm", "k_norm", "wo", "ln2", "gate_up", "down")
RANK_STACKED = ("wqkv", "wo", "gate_up", "down")


@dataclasses.dataclass
class StackedDecodeParams:
    """The persistent kernel's weights: ``layers``, the per-layer parameters
    (``models/qwen.py::QwenLayerParams``, kept alive here); ``table``, on
    the card, an (L, 8) int64 tensor of their addresses in
    :data:`LAYER_KINDS` order (0 for an absent qk-norm), None on the CPU;
    ``w_stride``, each kind's bytes from one rank's block to the next (0 for
    the one-copy norms)."""

    layers: list
    table: torch.Tensor | None
    w_stride: tuple[int, ...]

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    def weight(self, l: int, kind: str):
        lp = self.layers[l]
        return {"ln1": lp.ln1, "wqkv": lp.attn.wqkv, "q_norm": lp.attn.q_norm,
                "k_norm": lp.attn.k_norm, "wo": lp.attn.wo, "ln2": lp.ln2,
                "gate_up": lp.mlp.gate_up, "down": lp.mlp.down}[kind]


def stack_decode_params(params) -> StackedDecodeParams:
    """The layer table of ``params`` (``models/qwen.py::QwenParams`` of a
    dense model), built once (JAX ``models/qwen.py::stack_decode_params``
    stacks copies instead)."""
    layers = list(params.layers)
    first = layers[0]
    sp = StackedDecodeParams(layers, None, (0,) * len(LAYER_KINDS))
    strides = []
    for kind in LAYER_KINDS:
        w = sp.weight(0, kind)
        rank_stacked = kind in RANK_STACKED and w is not None and w.dim() == 3
        strides.append(w[0].numel() * w.element_size() if rank_stacked else 0)
    sp.w_stride = tuple(strides)
    if first.ln1.is_cuda:
        addrs = []
        for l in range(len(layers)):
            row = []
            for k in LAYER_KINDS:
                w = sp.weight(l, k)
                if w is not None and not w.is_contiguous():
                    raise ValueError(f"layer {l} {k}: the layer table needs contiguous weights")
                row.append(0 if w is None else w.data_ptr())
            addrs.append(row)
        sp.table = torch.tensor(addrs, dtype=torch.int64, device=first.ln1.device)
    return sp


# ---------------------------------------------------------------------------
# the schedule


def persistent_program(team: Team, me: int, layers: int, form: str = "ring",
                       buffers: int = 2) -> list:
    """The schedule of a K16 launch as far as ranks meet.

    ``form="ring"`` (the f32 and head dim 64 forms): JAX
    ``_persistent_decode_kernel``'s schedule (``:368-502``): the entry
    barrier; per layer the o-projection's instance (the first unarmed, every
    later one armed: it takes the previous instance's outstanding ACK
    credits), then the MLP's gate/up products, SwiGLU and its instance, into
    the reduced chunks of the instance's parity ("red0", "red1"); one ACK
    drain at exit.

    ``form="oneshot"`` (the served form): per layer two instances of
    ``comm/allreduce.py::one_shot_program`` without its entry barrier (the
    ranks meet through the arrivals alone), instance j = 2l (o) and 2l + 1
    (down, after the gate/up products and SwiGLU): the rank's partial
    ("x", j), rounded once, put into slot ``me`` of every rank's landing
    ``f"slots{j % buffers}"`` (each peer's credited on its ``recv[me]``), the
    n - 1 arrivals, and the slots summed in slot order in f32 into ("red",
    j).  The kernel double-buffers the landing by instance parity
    (``buffers=2``); with one buffer :func:`comm.ring.walk` finds a put that
    lands on a slot not yet summed.

    The local stages between (norms, the attention cell, the residual adds)
    are :func:`reference_decode_step`'s arithmetic."""
    if form == "oneshot":
        return _oneshot_program(team, me, layers, buffers)
    prog = []
    dl.collective_prologue(prog, team, me, neighbors_only=True)
    for l in range(layers):
        ring.chunk_ar_phase(prog, team, me, ("att", 0), "red0", armed=l > 0)
        prog += [Matmul(("g", 0), ("h", 0), ("wg", 0)), Matmul(("u", 0), ("h", 0), ("wu", 0)),
                 Swiglu(("act", 0), ("g", 0), ("u", 0))]
        ring.chunk_ar_phase(prog, team, me, ("act", 0), "red1", armed=True)
    ring.rs_ack_drain(prog, team.size)
    return prog


def _oneshot_program(team: Team, me: int, layers: int, buffers: int) -> list:
    n = team.size
    prog = []
    for l in range(layers):
        for j, (src, w) in enumerate(((("att", l), ("wo", l)), (("act", l), ("wd", l)))):
            inst = 2 * l + j
            if j == 1:
                prog += [Matmul(("g", l), ("h", l), ("wg", l)),
                         Matmul(("u", l), ("h", l), ("wu", l)),
                         Swiglu(("act", l), ("g", l), ("u", l))]
            prog.append(Matmul(("x", inst), src, w))
            slots = f"slots{inst % buffers}"
            dl.put(prog, slots, me, me, [("x", inst)])
            for off in range(1, n):
                dl.put(prog, slots, me, (me + off) % n, [("x", inst)], ("recv", me))
            for off in range(1, n):
                dl.wait(prog, ("recv", (me + n - off) % n))
            prog.append(Reduce(("red", inst), tuple((slots, i) for i in range(n)), True))
    return prog


def step_stages(form: str, layers: int, n: int) -> list[str]:
    """The stages one rank's lanes pass through in a K16 launch of ``form``
    (``"stream"``: csrc/persistent_decode_v2.cuh; ``"ring"``:
    persistent_decode.cuh), in order, each rank-wide barrier
    (``dl.cuh::rank_sync``) as ``"rank_sync"``: the kernels' layer loops
    written out."""
    out = ["copy_in", "rank_sync"]
    for _ in range(layers):
        if form == "stream":
            out += ["qkv", "attention", "rank_sync", "o", "rank_sync", "gate_up", "rank_sync",
                    "down", "rank_sync"]
            continue
        for stage in ("rms1", "qkv_partials", "qkv_finalize", "attn_splits", "attn_combine"):
            out += [stage, "rank_sync"]
        out += ["o_chunk", "rank_sync"] * n + ["residual", "rank_sync", "rms2", "rank_sync",
                                              "gate_up", "rank_sync", "swiglu", "rank_sync"]
        out += ["down_chunk", "rank_sync"] * n + ["residual", "rank_sync"]
    return out + ["copy_out"]


def step_joins(form: str, layers: int, n: int) -> int:
    """Rank-wide barriers a launch of ``form`` passes (:func:`step_stages`)."""
    return step_stages(form, layers, n).count("rank_sync")


# ---------------------------------------------------------------------------
# the served form's cut of the products


def served_form(dtype, d: int, g: int, b: int, k_dim: int, f: int) -> str:
    """``"stream"`` where K16's served form takes the step (bf16, head dim
    128, G in STREAM_GROUPS, B <= 4, hidden a multiple of 128 and a rank's
    intermediate of 64), else ``"ring"`` (PRs 7-14's body)."""
    if (dtype == torch.bfloat16 and d == STREAM_TILE and g in STREAM_GROUPS
            and b <= STREAM_MAX_B and k_dim % STREAM_TILE == 0 and f % 64 == 0):
        return "stream"
    return "ring"


def stream_geometry(product: str, k_dim: int, f: int, hk: int, g: int, lanes: int) -> dict:
    """One product of the served form as ``csrc/persistent_decode_v2.cuh``
    ``geo`` cuts it for a rank of ``lanes`` lanes: ``tiles`` tiles of 128
    output columns over the whole depth ``kd`` in ``ppt`` passes of 16 rows
    each, the passes of all tiles laid end to end and cut into one run a
    lane (``runs[l] = (q0, q1)``); ``ldw`` the weight's row length and
    ``half`` gate/up's first up column (else 0)."""
    hq = hk * g
    kd, tiles, ldw = {"qkv": (k_dim, hq + 2 * hk, (hq + 2 * hk) * STREAM_TILE),
                      "o": (hq * STREAM_TILE, k_dim // STREAM_TILE, k_dim),
                      "gate_up": (k_dim, f // 64, 2 * f),
                      "down": (f, k_dim // STREAM_TILE, k_dim)}[product]
    ppt = kd // STREAM_ROWS
    passes = tiles * ppt
    runs = [(passes * l // lanes, passes * (l + 1) // lanes) for l in range(lanes)]
    return dict(kd=kd, tiles=tiles, ppt=ppt, ldw=ldw, passes=passes, runs=runs,
                half=f if product == "gate_up" else 0)


def stream_tile_columns(geom: dict, tile: int) -> list[int]:
    """The weight columns of a tile (``col_of`` for its 16 lanes of 8)."""
    if geom["half"]:
        f = geom["half"]
        return ([tile * 64 + c for c in range(64)] + [f + tile * 64 + c for c in range(64)])
    return [tile * STREAM_TILE + c for c in range(STREAM_TILE)]


def stream_tile_lanes(geom: dict, tile: int) -> list[int]:
    """The lanes whose runs hold a pass of ``tile``, as the kernel finds them
    (``lane_of`` of the tile's first and last pass, less the empty runs
    between): the lanes that sum it, the last to arrive finishing it."""
    lanes, passes, ppt = len(geom["runs"]), geom["passes"], geom["ppt"]

    def lane_of(q):
        return ((q + 1) * lanes - 1) // passes

    first, last = lane_of(tile * ppt), lane_of((tile + 1) * ppt - 1)
    held = [j for j in range(first, last + 1)
            if passes * (j + 1) // lanes != passes * j // lanes]
    assert len(held) == (last - first + 1 if passes >= lanes else ppt)
    return held


def stream_splits(b: int, hk: int, capacity: int, lanes: int) -> int:
    """Attention splits a (sequence, kv head): about one item a lane, at most
    32 (the fold reads the splits' (m, l) a lane each)."""
    return max(1, min(lanes // max(1, b * hk), cdiv(capacity, STREAM_ROWS), 32))


def stream_regions(b: int, k_dim: int, f: int, hk: int, g: int, n: int, lanes: int,
                   n_split: int) -> tuple[list[int], int]:
    """Byte offsets of each rank's scratch regions of the served form
    (``core/symm.py::STREAM_REGIONS``) and the total, 256-byte aligned; the
    partials hold a (4, 128) f32 slot for each tile + lane."""
    hq = hk * g
    tiles = max(hq + 2 * hk, k_dim // STREAM_TILE, f // 64)
    sizes = [b * k_dim * 2, b * hq * STREAM_TILE * 2, b * f * 2, b * hq * STREAM_TILE * 2,
             b * hk * STREAM_TILE * 2, b * hk * STREAM_TILE * 2,
             (tiles + lanes) * STREAM_MAX_B * STREAM_TILE * 4,
             b * hk * n_split * g * STREAM_TILE * 4, b * hk * n_split * g * 2 * 4,
             2 * n * b * k_dim * 2]
    offs, at = [], 0
    for size in sizes:
        offs.append(at)
        at += cdiv(size, 256) * 256
    return offs, at


# ---------------------------------------------------------------------------
# plain versions


def _check_step(x, sp: StackedDecodeParams, pool_k, pool_v, block_table, seq_lens, n: int):
    """(L, B, K, hk, h, d, f): a rank's heads and MLP columns; raises as
    JAX ``persistent_decode_step`` does."""
    layers, _, hk, ps, d = pool_k.shape
    b, k_dim = x.shape
    if pool_v.shape != pool_k.shape:
        raise ValueError(f"pool shape mismatch: {tuple(pool_k.shape)} vs {tuple(pool_v.shape)}")
    if pool_k.dtype == torch.int8:
        raise NotImplementedError(
            "persistent decode needs full-precision pools (the in-kernel append cannot "
            "re-encode a page's int8 scale); int8-KV deployments keep decode_mode='fused'")
    if layers != sp.num_layers:
        raise ValueError(f"pools of {layers} layers, parameters of {sp.num_layers}")
    qkv_cols = sp.weight(0, "wqkv").shape[-1]
    h = qkv_cols // d - 2 * hk
    f = sp.weight(0, "down").shape[-2]
    if block_table.dim() != 2 or block_table.shape[0] != n * b or tuple(seq_lens.shape) != (n * b,):
        raise ValueError(f"block_table {tuple(block_table.shape)} / seq_lens "
                         f"{tuple(seq_lens.shape)} inconsistent with {n} rank(s) of B={b}")
    if h < 1 or h % hk:
        raise ValueError(f"wqkv {tuple(sp.weight(0, 'wqkv').shape)} does not hold [q|k|v] for "
                         f"{hk} kv heads at head_dim {d}")
    if k_dim % n:
        raise ValueError(f"hidden={k_dim} must divide by tp={n}")
    return layers, b, k_dim, hk, h, d, f


def _rank_weight(w: torch.Tensor, r: int) -> torch.Tensor:
    return w[r] if w.dim() == 3 else w


def _attn_jax(q, k_new, v_new, pool_k, pool_v, table, lens, sm_scale, soft_cap, dtype):
    """JAX ``reference_decode_step``'s attention (``:724-741``) over one
    rank's pages, after its append: softmax in f32 over [0, pos]."""
    b, hq, d = q.shape
    hk = pool_k.shape[1]
    ps = pool_k.shape[2]
    mp = table.shape[1]

    def gather(pool):
        g = pool[table.long()]                       # (B, mp, hk, ps, D)
        return g.transpose(1, 2).reshape(b, hk, mp * ps, d)

    kc = gather(pool_k).repeat_interleave(hq // hk, dim=1).float()
    vc = gather(pool_v).repeat_interleave(hq // hk, dim=1).float()
    scores = torch.einsum("bhd,bhkd->bhk", q.float(), kc) * sm_scale
    if soft_cap > 0.0:
        scores = soft_cap * torch.tanh(scores / soft_cap)
    mask = torch.arange(mp * ps, device=q.device)[None, :] <= lens.long()[:, None]
    scores = scores.masked_fill(~mask[:, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", probs, vc).to(dtype)


def _attn_layer_jax(h, sp, l, pool_k, pool_v, block_table, seq_lens, n, *, rope_theta,
                    qk_eps, sm_scale, soft_cap):
    """(B, H D) attention outputs of every rank's heads, rank-major, JAX's
    way; the token appended into layer l's pages (JAX: the page at pos //
    ps, unclamped)."""
    b = h.shape[0]
    _, _, hk, ps, d = pool_k.shape
    outs = []
    for r in range(n):
        w = _rank_weight(sp.weight(l, "wqkv"), r)
        hq = w.shape[-1] // d - 2 * hk
        qkv = torch.matmul(h.float(), w.float()).to(h.dtype)
        q, k, v = qkv.split([hq * d, hk * d, hk * d], dim=-1)
        q, k, v = q.reshape(b, hq, d), k.reshape(b, hk, d), v.reshape(b, hk, d)
        if qk_eps is not None:
            q = rms_norm(q, sp.weight(l, "q_norm"), qk_eps)
            k = rms_norm(k, sp.weight(l, "k_norm"), qk_eps)
        table, lens = block_table[r * b:(r + 1) * b], seq_lens[r * b:(r + 1) * b]
        pos = lens.long()[:, None, None]
        q = apply_rope_at(q[:, :, None, :], pos, theta=rope_theta)[:, :, 0]
        k = apply_rope_at(k[:, :, None, :], pos, theta=rope_theta)[:, :, 0]
        pages = table.long().gather(1, (lens.long() // ps)[:, None])[:, 0]
        offs = lens.long() % ps
        pool_k[l, pages, :, offs] = k.to(pool_k.dtype)
        pool_v[l, pages, :, offs] = v.to(pool_v.dtype)
        outs.append(_attn_jax(q, k, v, pool_k[l], pool_v[l], table, lens, sm_scale, soft_cap,
                              h.dtype).reshape(b, hq * d))
    return torch.cat(outs, dim=1)


def _mlp_act(h2: torch.Tensor, gate_up: torch.Tensor) -> torch.Tensor:
    """One rank's SwiGLU activation: g and u f32 sums rounded to h2's
    dtype, silu(g) * u in f32, rounded once (JAX ``_mlp_act_host``)."""
    fused = torch.matmul(h2.float(), gate_up.float()).to(h2.dtype)
    g, u = fused.chunk(2, dim=-1)
    return (F.silu(g.float()) * u.float()).to(h2.dtype)


def _cat_ranks(w: torch.Tensor) -> torch.Tensor:
    """Rank-stacked (n, R, C) rows as (n R, C)."""
    return w.reshape(-1, w.shape[-1]) if w.dim() == 3 else w


def reference_decode_step(x: torch.Tensor, sp: StackedDecodeParams, pool_k: torch.Tensor,
                          pool_v: torch.Tensor, block_table: torch.Tensor,
                          seq_lens: torch.Tensor, mesh: Mesh | None = None,
                          axis: str = TP_AXIS, *, rope_theta: float, rms_eps: float,
                          qk_eps: float | None = None, sm_scale: float | None = None,
                          soft_cap: float = 0.0, order: str = "ring"):
    """Plain version of one persistent step on the rank-folded pools:
    returns ``(x_out, pool_k, pool_v)``, the pools appended in place.

    ``order="ring"`` (default): the arithmetic of K16's f32 and head dim 64
    forms: per rank K4's attention (``fused_attn_decode_ref``), the
    o-projection and the MLP through K15's plain versions (the ring's
    schedule walked; at n == 1 one product rounded once), each residual
    added in x's dtype.  ``order="oneshot"``: the served form's: the same,
    but both reductions in K15's one-shot form (each rank's partial rounded
    once, the n partials summed in slot order in f32 and rounded once); at
    n == 1 the two orders are one.  ``order="jax"``: JAX's
    ``reference_decode_step`` (``persistent_decode.py:660``) on these pools."""
    n = 1 if mesh is None else mesh.shape[axis]
    layers, b, k_dim, hk, h, d, f = _check_step(x, sp, pool_k, pool_v, block_table, seq_lens, n)
    sm = d ** -0.5 if sm_scale is None else float(sm_scale)
    if order not in ("ring", "oneshot", "jax"):
        raise ValueError(f"order {order!r} not in ('ring', 'oneshot', 'jax')")
    for l in range(layers):
        hn = rms_norm(x, sp.weight(l, "ln1"), rms_eps)
        wo, gate_up, down = sp.weight(l, "wo"), sp.weight(l, "gate_up"), sp.weight(l, "down")
        if order == "jax":
            att = _attn_layer_jax(hn, sp, l, pool_k, pool_v, block_table, seq_lens, n,
                                  rope_theta=rope_theta, qk_eps=qk_eps, sm_scale=sm,
                                  soft_cap=soft_cap)
            x = x + torch.matmul(att.float(), _cat_ranks(wo).float()).to(x.dtype)
            h2 = rms_norm(x, sp.weight(l, "ln2"), rms_eps)
            act = torch.cat([_mlp_act(h2, _rank_weight(gate_up, r)) for r in range(n)], dim=1)
            x = x + torch.matmul(act.float(), _cat_ranks(down).float()).to(x.dtype)
            continue
        kw = dict(rope_theta=rope_theta, qk_eps=qk_eps, sm_scale=sm, soft_cap=soft_cap)
        wqkv = sp.weight(l, "wqkv")
        qn, kn = sp.weight(l, "q_norm"), sp.weight(l, "k_norm")
        if n == 1:
            att = fused_attn_decode_ref(hn, _rank_weight(wqkv, 0), qn, kn, pool_k[l], pool_v[l],
                                        block_table, seq_lens, **kw)[0]
        else:
            att = _fused_attn_folded_ref(hn, wqkv, qn, kn, pool_k[l], pool_v[l], block_table,
                                         seq_lens, **kw)[0]
        if n == 1:
            o = torch.matmul(att.float(), _rank_weight(wo, 0).float()).to(x.dtype)
        else:
            o = fused_linear_ar_ref(att, wo, mesh, axis, method=ORDERS[order])
        x = x + o
        h2 = rms_norm(x, sp.weight(l, "ln2"), rms_eps)
        if n == 1:
            act = _mlp_act(h2, _rank_weight(gate_up, 0))
            m = torch.matmul(act.float(), _rank_weight(down, 0).float()).to(x.dtype)
        else:
            m = fused_mlp_ar_ref(h2, gate_up, down, mesh, axis, method=ORDERS[order])
        x = x + m
    return x, pool_k, pool_v


# ---------------------------------------------------------------------------
# K16


@functools.lru_cache(maxsize=None)
def _lanes(d: int, g: int, dtype_code: int, n: int) -> int:
    lanes = build.library().tdt_persistent_lanes(d, g, dtype_code, n)
    if lanes <= 0:
        raise RuntimeError(f"persistent_decode: no co-resident lanes for D={d} G={g} n={n} "
                           f"({lanes})")
    return lanes


@functools.lru_cache(maxsize=None)
def _one_rank_mesh(device) -> Mesh:
    return make_mesh({TP_AXIS: 1}, device=device)


def persistent_plan(b: int, k_dim: int, f: int, hk: int, g: int, d: int, capacity: int,
                    page_size: int, n: int, lanes: int) -> dict:
    """K16's plans: the qkv projection's K slices (about two items a
    lane), the attention's prefix splits (an item a lane), and the three
    ring products' (``gemv_plan``)."""
    tiles = hk * (g + 2)
    nks = max(1, min(cdiv(2 * lanes, tiles), cdiv(k_dim, 64)))
    k_chunk = cdiv(cdiv(k_dim, nks), 64) * 64
    n_split = max(1, min(cdiv(lanes, b * hk), cdiv(capacity, page_size)))
    chunk = cdiv(cdiv(capacity, n_split), page_size) * page_size
    cn = k_dim // n
    return dict(proj_nks=cdiv(k_dim, k_chunk), proj_kchunk=k_chunk,
                n_split=cdiv(capacity, chunk), chunk=chunk,
                o=gemv_plan(b, hk * g * d, cn, lanes), up=gemv_plan(b, k_dim, 2 * f, lanes),
                dn=gemv_plan(b, f, cn, lanes))


def _regions(b, k_dim, f, hk, g, d, n, plan, itemsize) -> tuple[list[int], int]:
    """Byte offsets of each rank's scratch regions
    (``core/symm.py::PERSISTENT_REGIONS``) and the total, 256-byte aligned."""
    hq, cn = hk * g, k_dim // n
    ncols = (hq + 2 * hk) * d
    o, up, dn = plan["o"], plan["up"], plan["dn"]
    sizes = [b * k_dim * itemsize, b * k_dim * itemsize, b * hq * d * itemsize,
             b * f * itemsize, b * hq * d * itemsize, b * hk * d * itemsize,
             b * hk * d * itemsize, plan["proj_nks"] * b * ncols * 4,
             b * hk * plan["n_split"] * g * d * 4, b * hk * plan["n_split"] * g * 2 * 4,
             max(up.n_kslice * b * 2 * f, 2 * o.n_kslice * b * cn, 2 * dn.n_kslice * b * cn) * 4]
    offs, at = [], 0
    for size in sizes:
        offs.append(at)
        at += cdiv(size, 256) * 256
    return offs, at


@functools.lru_cache(maxsize=None)
def _stream_lanes(g: int, n: int) -> int:
    lanes = build.library().tdt_persistent_v2_lanes(g, n)
    if lanes <= 0:
        raise RuntimeError(f"persistent_decode: no co-resident lanes for the served form at G={g} "
                           f"n={n} ({lanes})")
    return lanes


def form_lanes(form: str, dtype, d: int, g: int, n: int) -> int:
    """The lanes a rank gets in a K16 launch of ``form``."""
    if form == "stream":
        return _stream_lanes(g, n)
    return _lanes(d, g, KERNEL_DTYPES[dtype], n)


def _launch(x, sp, pool_k, pool_v, block_table, seq_lens, mesh: Mesh, axis: str, *, rope_theta,
            rms_eps, qk_eps, sm_scale, soft_cap, stall_rank: int = -1, form: str | None = None):
    """K16 on every rank of the mesh; returns x_out.  ``form`` None takes
    :func:`served_form`'s; ``"ring"`` forces PRs 7-14's body (the parent's
    K16 at the served shapes, for comparisons).  A ``stall_rank`` of 0 or
    more (tests of the bounded waits only) makes that rank credit none of
    its puts."""
    layers, b, k_dim, hk, h, d, f = _check_step(x, sp, pool_k, pool_v, block_table, seq_lens,
                                                mesh.shape[axis])
    team = Team.of(mesh, axis)
    n = team.size
    g = h // hk
    form = form or served_form(x.dtype, d, g, b, k_dim, f)
    if form == "stream" and served_form(x.dtype, d, g, b, k_dim, f) != "stream":
        raise ValueError(f"K16's served form does not take {x.dtype}, head_dim {d}, G={g}, "
                         f"B={b}, hidden {k_dim}, intermediate / tp {f}")
    if d not in KERNEL_HEAD_DIMS or g not in KERNEL_GROUPS:
        raise ValueError(f"head_dim {d} / {g} query heads per kv head: K16 is built for "
                         f"{KERNEL_HEAD_DIMS} / {KERNEL_GROUPS}")
    if (k_dim // n) % 8 or f % 8:
        raise ValueError(f"hidden / tp = {k_dim // n} and intermediate / tp = {f} must be "
                         "multiples of 8 (16-byte rows)")
    if pool_k.dtype != x.dtype or x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"x {x.dtype}, pools {pool_k.dtype}: K16 takes f32 or bf16, pools "
                        "in x's dtype")
    check_int32(block_table=block_table, seq_lens=seq_lens)
    if sp.table is None or sp.table.device != x.device:
        raise ValueError("the layer table lives on another device than x")
    _, _, _, ps, _ = pool_k.shape
    mp = block_table.shape[1]
    dev = x.device
    if form == "stream":
        return _launch_stream(x, sp, pool_k, pool_v, block_table, seq_lens, mesh, axis, team,
                              layers, b, k_dim, hk, g, f, ps, mp, rope_theta=rope_theta,
                              rms_eps=rms_eps, qk_eps=qk_eps, sm_scale=sm_scale,
                              soft_cap=soft_cap, stall_rank=stall_rank)
    es = x.element_size()
    lanes = _lanes(d, g, KERNEL_DTYPES[x.dtype], n)
    plan = persistent_plan(b, k_dim, f, hk, g, d, mp * ps, ps, n, lanes)
    offs, total = _regions(b, k_dim, f, hk, g, d, n, plan, es)
    fam = "persistent"
    chunk = b * (k_dim // n)
    mm = symm.landing(mesh, axis, f"{fam}_mm", (n, chunk), x.dtype).data
    red = symm.landing(mesh, axis, f"{fam}_out", (2 * n, chunk), x.dtype).data
    land = symm.landing(mesh, axis, fam, (2, chunk), x.dtype)
    scratch = symm.landing(mesh, axis, f"{fam}_scratch", (total,), torch.uint8).data
    x_out = torch.empty_like(x)
    coll = symm.coll_args(team, mesh, x=mm, out=red, land=land,
                          pad=symm.signal_pad(mesh, axis, fam), chunk_elems=chunk, method=0,
                          stall_rank=stall_rank)
    coll.dtype = coll.out_dtype = KERNEL_DTYPES[x.dtype]
    x_in = x.contiguous()
    args = symm.PersistentArgs(
        c=coll, layers=sp.table.data_ptr(),
        w_stride=(ctypes.c_longlong * 8)(*sp.w_stride),
        x_in=x_in.data_ptr(), x_out=x_out.data_ptr(), pool_k=pool_k.data_ptr(),
        pool_v=pool_v.data_ptr(), table=block_table.data_ptr(), lens=seq_lens.data_ptr(),
        inv_freq=_inv_freq(dev, d, float(rope_theta)).data_ptr(),
        scratch=symm.peers(symm.slot_ptrs(scratch, mesh)),
        off=(ctypes.c_longlong * len(offs))(*offs),
        layer_pool_elems=pool_k[0].numel(), L=layers, B=b, K=k_dim, F=f, hk=hk, ps=ps, mp=mp,
        proj_nks=plan["proj_nks"], proj_kchunk=plan["proj_kchunk"], n_split=plan["n_split"],
        chunk=plan["chunk"], o=plan["o"], up=plan["up"], dn=plan["dn"],
        sm_scale=sm_scale, soft_cap=float(soft_cap),
        qk_eps=float(qk_eps) if qk_eps is not None else 0.0, rms_eps=float(rms_eps),
        qk_norm=int(qk_eps is not None))
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(build.library().tdt_persistent_decode(ctypes.byref(args), d, g, stream),
                "persistent_decode")
    count("persistent_decode", (n, layers, b, k_dim))
    return x_out


def _launch_stream(x, sp, pool_k, pool_v, block_table, seq_lens, mesh: Mesh, axis: str,
                   team: Team, layers, b, k_dim, hk, g, f, ps, mp, *, rope_theta, rms_eps, qk_eps,
                   sm_scale, soft_cap, stall_rank: int):
    """K16's served form (``csrc/persistent_decode_v2.cu``) on every rank."""
    n = team.size
    dev = x.device
    lanes = _stream_lanes(g, n)
    n_split = stream_splits(b, hk, mp * ps, lanes)
    offs, total = stream_regions(b, k_dim, f, hk, g, n, lanes, n_split)
    scratch = symm.landing(mesh, axis, "persistent_stream", (total,), torch.uint8).data
    x_out = torch.empty_like(x)
    coll = symm.coll_args(team, mesh, x=scratch, out=scratch, land=None,
                          pad=symm.signal_pad(mesh, axis, "persistent"), chunk_elems=0, method=0,
                          stall_rank=stall_rank)
    coll.dtype = coll.out_dtype = KERNEL_DTYPES[x.dtype]
    x_in = x.contiguous()
    args = symm.StreamArgs(
        c=coll, layers=sp.table.data_ptr(), w_stride=(ctypes.c_longlong * 8)(*sp.w_stride),
        x_in=x_in.data_ptr(), x_out=x_out.data_ptr(), pool_k=pool_k.data_ptr(),
        pool_v=pool_v.data_ptr(), table=block_table.data_ptr(), lens=seq_lens.data_ptr(),
        inv_freq=_inv_freq(dev, STREAM_TILE, float(rope_theta)).data_ptr(),
        scratch=symm.peers(symm.slot_ptrs(scratch, mesh)),
        off=(ctypes.c_longlong * len(offs))(*offs), layer_pool_elems=pool_k[0].numel(),
        L=layers, B=b, K=k_dim, F=f, hk=hk, ps=ps, mp=mp, n_split=n_split,
        sm_scale=sm_scale, soft_cap=float(soft_cap),
        qk_eps=float(qk_eps) if qk_eps is not None else 0.0, rms_eps=float(rms_eps),
        qk_norm=int(qk_eps is not None))
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(build.library().tdt_persistent_v2(ctypes.byref(args), g, stream),
                "persistent_decode")
    count("persistent_decode", (n, layers, b, k_dim))
    return x_out


def persistent_decode_step(x: torch.Tensor, sp: StackedDecodeParams, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, block_table: torch.Tensor,
                           seq_lens: torch.Tensor, mesh: Mesh | None = None,
                           axis: str = TP_AXIS, *, rope_theta: float = 10_000.0,
                           rms_eps: float = 1e-6, qk_eps: float | None = None,
                           sm_scale: float | None = None, soft_cap: float = 0.0,
                           config=None):
    """One decode step through every layer (JAX ``persistent_decode.py:744``).

    ``x``: (B, K) embedded tokens; ``sp``: :func:`stack_decode_params`;
    ``pool_k``/``pool_v``: (L, n P, Hkv / n, ps, D) full-precision pools,
    appended in place; ``block_table`` (n B, max_pages) and ``seq_lens``
    (n B,) the rank-folded ones; ``mesh`` None or one rank for tp = 1.
    Returns ``(x_out, pool_k, pool_v)``, ``x_out`` the hidden state after the
    last layer (before the final norm).  CUDA tensors launch K16 (at any n,
    one launch; :func:`served_form` picks its form); CPU tensors take the
    plain version: at n == 1 JAX's reference step, else
    :func:`reference_decode_step` in the order of the form the card would
    launch ("oneshot" for the served form, else "ring").  int8 pools raise,
    as JAX's."""
    check_config(config)
    n = 1 if mesh is None else mesh.shape[axis]
    _, b, k_dim, hk, h, d, f = _check_step(x, sp, pool_k, pool_v, block_table, seq_lens, n)
    sm = d ** -0.5 if sm_scale is None else float(sm_scale)
    kw = dict(rope_theta=rope_theta, rms_eps=rms_eps, qk_eps=qk_eps, sm_scale=sm,
              soft_cap=soft_cap)
    if not x.is_cuda:
        stream = served_form(x.dtype, d, h // hk, b, k_dim, f) == "stream"
        order = "jax" if n == 1 else ("oneshot" if stream else "ring")
        return reference_decode_step(x, sp, pool_k, pool_v, block_table, seq_lens, mesh, axis,
                                     order=order, **kw)
    if mesh is None:
        mesh, axis = _one_rank_mesh(x.device), TP_AXIS
    kw.pop("sm_scale")
    x_out = _launch(x, sp, pool_k, pool_v, block_table, seq_lens, mesh, axis, sm_scale=sm, **kw)
    return x_out, pool_k, pool_v


def decode_bundle(step, cache, tokens: torch.Tensor, steps: int):
    """``steps`` greedy decode steps (JAX ``decode_bundle``):
    ``step(cache, tokens) -> (logits, cache)``; each step's argmax is fed
    back on the device, so nothing is read back to the host between steps.
    Returns ``(tokens (steps, B) int32, cache)``."""
    tok = tokens.to(torch.int32)
    out = []
    for _ in range(int(steps)):
        logits, cache = step(cache, tok)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
    return torch.stack(out), cache
