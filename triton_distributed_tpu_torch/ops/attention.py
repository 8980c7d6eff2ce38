"""Local attention: flash-attention prefill and single-token decode over a
contiguous or a paged KV cache.

Counterpart of ``triton_distributed_tpu/ops/attention.py``, with the same
signatures and layouts at the public functions.  Each function has a plain
PyTorch version beside it (``*_ref``) and a hand-written CUDA kernel in
``csrc/`` that replaces a Pallas kernel of ``ops/attention.py``:

- ``flash_attention``: ``flash_attention.cu``, replacing ``_attn_kernel``;
- ``decode_attention``: ``decode_cluster.cu`` (bf16, D = 128: one
  clustered launch) or ``decode_attention.cu`` (f32, D = 64: a split pass
  and a combine), replacing ``_decode_fused_kernel``;
- ``paged_decode_attention``: the same two, replacing
  ``_paged_decode_kernel`` with pages in q's type or int8 pages;
- ``decode_attention_state`` and ``paged_decode_attention_state`` (K7):
  ``decode_attention.cu``, replacing ``_decode_kernel`` and the ``_state``
  form of ``_paged_decode_kernel``; ``merge_decode_states`` is plain torch
  ops, as JAX computes it in jnp;
- ``flash_attention_chunk`` (K8): ``flash_attention.cu``, replacing
  ``_attn_chunk_kernel``, with ``init_attention_state`` and
  ``finalize_attention_state`` around it.

A wrapper takes the plain version only for tensors on the CPU.  For CUDA
tensors it launches its kernel or raises; it never falls back.  Each wrapper
counts its launches in ``core.launches`` (the int8 page variant of the paged
kernel under its own name), so a caller can show that a run went through the
kernels.

The plain versions keep the JAX kernels' rounding points: q is scaled in f32
and cast to the storage type before the q.k product, scores and softmax
state are f32, and p is cast to the V type before the p.v product.  int8
pages follow ``_tile_update`` (JAX ``ops/attention.py:76-105``): the codes
are exact in the q type, the (page, head) K scale multiplies the f32 score
after the product, p is cast to the q type, and the V scale multiplies the
p.v product.
"""

from __future__ import annotations

import functools

import torch

from ..core import build
from ..core.launches import count
from ..core.platform import resolve_device
from ..core.utils import cdiv

_NEG_INF = -1e30
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_GROUPS = (1, 2, 4, 8)       # query heads per kv head in the decode kernel
DECODE_BLOCKS_PER_SM = 4           # split-count target of the split + combine pass
DECODE_PIECE = 16                  # rows of a piece in the clustered form: the mma's k-depth
DECODE_CLUSTER = 8                 # blocks of the clustered form a (batch, kv head)


# ---------------------------------------------------------------------------
# plain PyTorch versions


def _scaled_q(q: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """Scale in f32, round to the storage type (the JAX ``_scaled_q``)."""
    return (q.float() * sm_scale).to(q.dtype)


def _softmax_pv(s: torch.Tensor, v: torch.Tensor, keep, soft_cap: float,
                p_dtype=None, v_scale=None):
    """Masked softmax over the last axis of f32 scores ``s`` and its product
    with ``v``.  p is rounded to ``p_dtype`` (default v's dtype) and then,
    for int8 values, multiplied by their per-position ``v_scale``.  Returns
    the unnormalized f32 (p.v, l); a fully masked row has p = 0 and l = 0."""
    if soft_cap:
        s = torch.tanh(s / soft_cap) * soft_cap
    if keep is not None:
        s = torch.where(keep, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if keep is not None:
        p = torch.where(m > _NEG_INF / 2, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    pr = p.to(p_dtype or v.dtype).float()
    if v_scale is not None:
        pr = pr * v_scale
    return torch.matmul(pr, v.float()), l


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        sm_scale: float | None = None,
                        soft_cap: float = 0.0) -> torch.Tensor:
    """Plain version of :func:`flash_attention` (one softmax over the whole
    row rather than online over tiles)."""
    b, h, sq, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    g = h // hk
    sm_scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    qs = _scaled_q(q, sm_scale).float().reshape(b, hk, g, sq, d)
    s = torch.matmul(qs, k.float().unsqueeze(2).transpose(-1, -2))
    keep = None
    if causal:
        pos_q = torch.arange(sq, device=q.device)
        pos_k = torch.arange(skv, device=q.device)
        keep = pos_k[None, :] <= pos_q[:, None]
    pv, l = _softmax_pv(s, v.unsqueeze(2), keep, soft_cap)
    return (pv / l).to(q.dtype).reshape(b, h, sq, d)


def _lens(kv_len, b: int, device) -> torch.Tensor:
    """(B,) int32 lengths from a scalar or a (B,) tensor."""
    if isinstance(kv_len, torch.Tensor):
        if kv_len.dim() not in (0, 1) or kv_len.numel() not in (1, b):
            raise ValueError(f"kv_len {tuple(kv_len.shape)} is not a scalar or (B,)")
        return kv_len.to(device=device, dtype=torch.int32).reshape(-1).expand(b).contiguous()
    return torch.full((b,), int(kv_len), dtype=torch.int32, device=device)


def decode_ref(q, k, v, keep, *, sm_scale: float, soft_cap: float = 0.0,
               p_dtype=None, k_scale=None, v_scale=None) -> torch.Tensor:
    """Single-token attention of ``q`` (B, H, D) over the positions of
    ``k``/``v`` (B, Hkv, S, D) where ``keep`` (B, S) holds.  int8 codes come
    with per-position scales ``k_scale``/``v_scale`` (B, Hkv, S).  p is
    rounded to ``p_dtype`` (default v's dtype).  A row with no kept position
    returns zeros."""
    b, h, d = q.shape
    hk = k.shape[1]
    qs = _scaled_q(q, sm_scale).float().reshape(b, hk, h // hk, 1, d)
    s = torch.matmul(qs, k.float().unsqueeze(2).transpose(-1, -2))  # (b,hk,g,1,S)
    vs = None
    if k_scale is not None:
        s = s * k_scale[:, :, None, None, :]
        vs = v_scale[:, :, None, None, :]
    pv, l = _softmax_pv(s, v.unsqueeze(2), keep[:, None, None, None, :],
                        soft_cap, p_dtype, vs)
    out = torch.where(l > 0, pv / l.clamp_min(1e-38), torch.zeros_like(pv))
    return out.to(q.dtype).reshape(b, h, d)


def decode_attention_ref(q, k, v, kv_len, *, sm_scale: float | None = None,
                         soft_cap: float = 0.0) -> torch.Tensor:
    """Plain version of :func:`decode_attention`: positions at or past
    ``kv_len`` are masked; a length-0 row returns zeros."""
    b, _, d = q.shape
    sm_scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    lens = _lens(kv_len, b, q.device)
    keep = torch.arange(k.shape[2], device=q.device)[None, :] < lens[:, None]
    return decode_ref(q, k, v, keep, sm_scale=sm_scale, soft_cap=soft_cap)


def gather_pages(pool: torch.Tensor, block_table: torch.Tensor,
                 scale: torch.Tensor | None = None):
    """Each sequence's pages of ``pool`` (P, Hkv, ps, D) as a contiguous
    (B, Hkv, max_pages * ps, D) cache, and, given the (P, Hkv) page scales,
    the (B, Hkv, max_pages * ps) scale of each position."""
    b, mp = block_table.shape
    _, hk, ps, d = pool.shape
    table = block_table.long()
    vals = pool[table].permute(0, 2, 1, 3, 4).reshape(b, hk, mp * ps, d)
    if scale is None:
        return vals, None
    pos_scale = scale[table].permute(0, 2, 1).repeat_interleave(ps, dim=2)
    return vals, pos_scale.float()


def paged_decode_attention_ref(q, pool_k, pool_v, block_table, seq_lens, *,
                               sm_scale: float | None = None,
                               soft_cap: float = 0.0, k_scale=None,
                               v_scale=None) -> torch.Tensor:
    """Plain version of :func:`paged_decode_attention`: gathers each
    sequence's pages into a contiguous cache, then masks by ``seq_lens``;
    int8 pages keep their codes and carry their scales per position."""
    d = q.shape[2]
    sm_scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    k, ks = gather_pages(pool_k, block_table, k_scale)
    v, vs = gather_pages(pool_v, block_table, v_scale)
    keep = (torch.arange(k.shape[2], device=q.device)[None, :]
            < seq_lens.to(q.device)[:, None])
    return decode_ref(q, k, v, keep, sm_scale=sm_scale, soft_cap=soft_cap,
                      p_dtype=q.dtype, k_scale=ks, v_scale=vs)


# ---------------------------------------------------------------------------
# argument checks shared by the wrappers


def _check_tensors(names, tensors, *, float_like: bool = True) -> None:
    dev = tensors[0].device
    dt = tensors[0].dtype
    for name, t in zip(names, tensors):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, {names[0]} on {dev}")
        if float_like and t.dtype != dt:
            raise TypeError(f"{name} has dtype {t.dtype}, {names[0]} {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if float_like and dt not in KERNEL_DTYPES:
        raise TypeError(f"dtype {dt} not supported: use bfloat16 or float32")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"device {dev} not supported")


def _check_kernel_shape(d: int, group: int | None = None) -> None:
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"head_dim {d} has no CUDA kernel (built for {KERNEL_HEAD_DIMS})")
    if group is not None and group not in KERNEL_GROUPS:
        raise ValueError(
            f"{group} query heads per kv head has no CUDA decode kernel "
            f"(built for {KERNEL_GROUPS})")


def _stream(device) -> int:
    """PyTorch's current stream on ``device``, as the integer handle the C
    entry points take: kernels launch there and do not synchronize."""
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# K1: flash-attention prefill

FLASH_BQ, FLASH_BKV = 64, 64   # K1's wgmma body: q rows a head, kv rows a tile


def flash_work_items(b: int, h: int, hk: int, sq: int, skv: int,
                     causal: bool, delta: int = 0) -> list[tuple[int, int, tuple, int]]:
    """The units of K1's served form and K8's fold (bf16, D = 128) in their
    order, as ``fa::item`` in ``csrc/flash_attention.cu`` numbers them: (q
    tile, batch, q heads, kv tiles read).  A unit is 64 query rows of two q
    heads of one kv head (one where the group is odd and this is its last
    pair), heaviest q tile first; a causal tile reads the kv tiles up to its
    diagonal, K8's at ``delta = q_offset - kv_offset`` (key j is visible to
    query i when j <= i + delta): none when every row precedes the chunk,
    and then the unit copies its state through."""
    g = h // hk
    pairs = cdiv(g, 2)
    per, nqt = b * hk * pairs, cdiv(sq, FLASH_BQ)
    items = []
    for u in range(per * nqt):
        r, qt = u % per, nqt - 1 - u // per
        bb, kh, pair = r // (hk * pairs), (r // pairs) % hk, r % pairs
        heads = tuple(kh * g + 2 * pair + w for w in range(min(2, g - 2 * pair)))
        n_kt, last = cdiv(skv, FLASH_BKV), min(qt * FLASH_BQ + FLASH_BQ, sq) - 1 + delta
        if causal:
            n_kt = 0 if last < 0 else min(n_kt, last // FLASH_BKV + 1)
        items.append((qt, bb, heads, n_kt))
    return items


def flash_block_units(units: int, blocks: int) -> list[list[int]]:
    """The units each persistent block of K1's served form takes, in turn
    (``fa::unit_of``): rounds of ``blocks`` units, every other round walked
    backwards."""
    return [[u for n in range(cdiv(units, blocks))
             if (u := n * blocks + (blocks - 1 - blk if n % 2 else blk)) < units]
            for blk in range(blocks)]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: float | None = None,
                    soft_cap: float = 0.0,
                    segment_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Blocked online-softmax attention.  ``q``: (B, H, Sq, D);
    ``k``/``v``: (B, Hkv, Skv, D) with H a multiple of Hkv (GQA).
    ``causal`` requires Sq == Skv.  Returns (B, H, Sq, D) in q's dtype."""
    if segment_ids is not None:
        raise NotImplementedError(
            "segment_ids (packed varlen prefill) belongs to a later slice of "
            "the port")
    _check_tensors(("q", "k", "v"), (q, k, v))
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q={tuple(q.shape)} k={tuple(k.shape)} "
                         f"v={tuple(v.shape)}")
    b, h, sq, d = q.shape
    bk_, hk, skv, dk = k.shape
    if (bk_, dk) != (b, d):
        raise ValueError(f"shape mismatch: q={tuple(q.shape)} k={tuple(k.shape)}")
    if h % hk:
        raise ValueError(f"GQA requires H % Hkv == 0, got {h} % {hk}")
    if causal and sq != skv:
        raise ValueError("causal prefill requires Sq == Skv (decode uses "
                         "decode_attention)")
    sm_scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, sm_scale=sm_scale,
                                   soft_cap=soft_cap)
    _check_kernel_shape(d)
    out = torch.empty_like(q)
    lib = build.library()
    err = lib.tdt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, hk,
        sq, skv, d, int(bool(causal)), sm_scale, float(soft_cap),
        KERNEL_DTYPES[q.dtype], _stream(q.device))
    build.check(err, "flash_attention")
    count("flash_attention")
    return out


# ---------------------------------------------------------------------------
# K2 / K3: decode over a contiguous or a paged cache


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_split_plan(pairs: int, capacity: int, device,
                      granule: int = 64) -> tuple[int, int]:
    """(n_split, chunk): cut a sequence of up to ``capacity`` positions into
    splits of ``chunk`` positions (a multiple of ``granule``) so that
    ``pairs`` (batch x kv head) blocks per split reach about
    ``DECODE_BLOCKS_PER_SM`` blocks per SM.  Splits past a sequence's length
    exit without reading anything."""
    want = cdiv(DECODE_BLOCKS_PER_SM * _sm_count(device.index), pairs)
    n = max(1, min(want, cdiv(capacity, granule)))
    chunk = cdiv(cdiv(capacity, n), granule) * granule
    return cdiv(capacity, chunk), chunk


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def decode_pieces(length: int, cluster: int = DECODE_CLUSTER,
                  page_size: int | None = None) -> list[list[tuple[int, int]]]:
    """Each block's share of a sequence of ``length`` positions in the
    clustered form of K2/K3 (``csrc/decode_cluster.cu``), as its pieces'
    [start, end) ranges: the cdiv(length, 16) pieces of 16 rows (the last
    one partial) cut into ``cluster`` even shares, block r taking pieces [r
    n / cluster, (r + 1) n / cluster) (the kernel reads the length on the
    device).  A page must hold a multiple of 16 rows, so that no piece
    straddles one."""
    if page_size is not None and page_size % DECODE_PIECE:
        raise ValueError(f"page_size {page_size} is not a multiple of {DECODE_PIECE}")
    n = cdiv(max(int(length), 0), DECODE_PIECE)
    return [[(DECODE_PIECE * i, min(DECODE_PIECE * (i + 1), length))
             for i in range(r * n // cluster, (r + 1) * n // cluster)]
            for r in range(cluster)]


def _clustered(q: torch.Tensor, d: int, page_size: int | None = None) -> bool:
    """Whether the clustered form serves the call: bf16 queries at D = 128
    over a contiguous cache or pages of a multiple of 16 rows."""
    return (q.dtype == torch.bfloat16 and d == 128
            and (page_size is None or page_size % DECODE_PIECE == 0))


def _length_arg(kv_len, b: int, device) -> tuple[torch.Tensor | None, int, int]:
    """The clustered form's lengths as (tensor, stride, int): an int goes in
    as a kernel argument, a 0-d or one-element tensor with stride 0, a (B,)
    tensor as it is.  Only a tensor of another dtype or device is copied."""
    if not isinstance(kv_len, torch.Tensor):
        return None, 0, int(kv_len)
    if kv_len.dim() not in (0, 1) or kv_len.numel() not in (1, b):
        raise ValueError(f"kv_len {tuple(kv_len.shape)} is not a scalar or (B,)")
    if kv_len.dtype != torch.int32 or kv_len.device != device:
        kv_len = kv_len.to(device=device, dtype=torch.int32)
    return kv_len, (0 if kv_len.numel() == 1 else kv_len.stride(0)), 0


def _launch_cluster(q, k, v, kv_len, table, capacity: int, page_size: int,
                    max_pages: int, sm_scale: float, soft_cap: float, name: str,
                    k_scale=None, v_scale=None) -> torch.Tensor:
    b, h, _ = q.shape
    lens, stride, const = _length_arg(kv_len, b, q.device)
    out = torch.empty_like(q)
    err = build.library().tdt_decode_cluster(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(lens), stride, const,
        _ptr(table), _ptr(k_scale), _ptr(v_scale), out.data_ptr(), b, h,
        k.shape[1], capacity, page_size, max_pages,
        k.shape[0] if table is not None else 0, sm_scale, float(soft_cap),
        _stream(q.device))
    build.check(err, name)
    return out


def _launch_decode(q, k, v, lens, table, capacity: int, page_size: int,
                   max_pages: int, sm_scale: float, soft_cap: float,
                   name: str, k_scale=None, v_scale=None) -> torch.Tensor:
    b, h, d = q.shape
    hk = k.shape[1]
    g = h // hk
    n_split, chunk = decode_split_plan(
        b * hk, capacity, q.device, granule=page_size or 64)
    part_acc = torch.empty((b * hk * n_split * g * d,), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b * hk * n_split * g * 2,), dtype=torch.float32,
                          device=q.device)
    out = torch.empty_like(q)
    lib = build.library()
    err = lib.tdt_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        _ptr(table), _ptr(k_scale), _ptr(v_scale), part_acc.data_ptr(),
        part_ml.data_ptr(), out.data_ptr(), b, h, hk, d, capacity, page_size,
        max_pages, n_split, chunk, sm_scale, float(soft_cap),
        KERNEL_DTYPES[q.dtype], _stream(q.device))
    build.check(err, name)
    return out


def check_page_scales(pool_k, pool_v, k_scale, v_scale) -> bool:
    """Whether the pools are int8 with (P, Hkv) f32 scales (True) or full
    precision without scales (False); raises on anything in between."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale or neither")
    if k_scale is None:
        return False
    _check_tensors(("pool_k", "pool_v", "k_scale", "v_scale"),
                   (pool_k, pool_v, k_scale, v_scale), float_like=False)
    if pool_k.dtype != torch.int8 or pool_v.dtype != torch.int8:
        raise TypeError(f"scaled pools must be int8, got {pool_k.dtype} / "
                        f"{pool_v.dtype}")
    want = tuple(pool_k.shape[:2])
    for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
        if tuple(sc.shape) != want or sc.dtype != torch.float32:
            raise ValueError(f"{name} {tuple(sc.shape)} {sc.dtype} is not "
                             f"(P, Hkv) = {want} float32")
    return True


def _check_decode_q(q, k_like, names) -> tuple[int, int, int, int]:
    if k_like.dtype == torch.int8:
        _check_tensors(names[:1], (q,))
        _check_tensors(names, (q, k_like), float_like=False)
    else:
        _check_tensors(names, (q, k_like))
    if q.dim() != 3 or k_like.dim() != 4:
        raise ValueError(f"{names[0]} must be (B, H, D) and {names[1]} 4-D, got "
                         f"{tuple(q.shape)} and {tuple(k_like.shape)}")
    b, h, d = q.shape
    hk = k_like.shape[1]
    if k_like.shape[3] != d:
        raise ValueError(f"head_dim mismatch: q={tuple(q.shape)} "
                         f"{names[1]}={tuple(k_like.shape)}")
    if h % hk:
        raise ValueError(f"GQA requires H % Hkv == 0, got {h} % {hk}")
    return b, h, d, hk


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len, *, sm_scale: float | None = None,
                     soft_cap: float = 0.0) -> torch.Tensor:
    """Single-token decode over a contiguous cache.  ``q``: (B, H, D);
    ``k``/``v``: (B, Hkv, Smax, D); ``kv_len``: int, 0-d or (B,) tensor of
    valid lengths (ragged).  Returns (B, H, D); a length-0 row is zeros.
    bf16 at D = 128 is one clustered launch, the length read on the device
    (an int32 tensor on q's device is not copied)."""
    b, h, d, hk = _check_decode_q(q, k, ("q", "k"))
    _check_tensors(("k", "v"), (k, v))
    if k.shape[0] != b or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q={tuple(q.shape)} k={tuple(k.shape)} "
                         f"v={tuple(v.shape)}")
    sm_scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kv_len, sm_scale=sm_scale,
                                    soft_cap=soft_cap)
    _check_kernel_shape(d, h // hk)
    if _clustered(q, d):
        out = _launch_cluster(q, k, v, kv_len, None, k.shape[2], 0, 0, sm_scale,
                              soft_cap, "decode_attention")
    else:
        out = _launch_decode(q, k, v, _lens(kv_len, b, q.device), None,
                             k.shape[2], 0, 0, sm_scale, soft_cap,
                             "decode_attention")
    count("decode_attention")
    return out


def paged_decode_attention(q: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, block_table: torch.Tensor,
                           seq_lens: torch.Tensor, *,
                           sm_scale: float | None = None,
                           soft_cap: float = 0.0,
                           k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Single-token decode over a paged cache.  ``q``: (B, H, D);
    ``pool_k``/``pool_v``: (P, Hkv, page_size, D); ``block_table``: (B,
    max_pages) int32, logical page j of sequence b in pool page
    ``block_table[b, j]`` (entries past a sequence's pages must still be
    valid pool indices, e.g. 0; they are never read); ``seq_lens``: (B,)
    int32 ragged lengths.  int8 pools come with ``k_scale``/``v_scale``
    (P, Hkv) f32, one scale per (page, head).  Returns (B, H, D)."""
    quantized = check_page_scales(pool_k, pool_v, k_scale, v_scale)
    b, h, d, hk = _check_decode_q(q, pool_k, ("q", "pool_k"))
    _check_tensors(("pool_k", "pool_v"), (pool_k, pool_v),
                   float_like=not quantized)
    _check_tensors(("block_table", "seq_lens"), (block_table, seq_lens),
                   float_like=False)
    if pool_v.shape != pool_k.shape:
        raise ValueError(f"pool_k {tuple(pool_k.shape)} != pool_v "
                         f"{tuple(pool_v.shape)}")
    if block_table.dim() != 2 or block_table.shape[0] != b \
            or tuple(seq_lens.shape) != (b,):
        raise ValueError(f"block_table {tuple(block_table.shape)} / seq_lens "
                         f"{tuple(seq_lens.shape)} inconsistent with B={b}")
    if block_table.device != q.device or seq_lens.device != q.device:
        raise ValueError("block_table and seq_lens must be on q's device")
    sm_scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, pool_k, pool_v, block_table,
                                          seq_lens, sm_scale=sm_scale,
                                          soft_cap=soft_cap, k_scale=k_scale,
                                          v_scale=v_scale)
    _check_kernel_shape(d, h // hk)
    check_int32(block_table=block_table, seq_lens=seq_lens)
    ps, mp = pool_k.shape[2], block_table.shape[1]
    name = "paged_decode_attention_int8" if quantized else "paged_decode_attention"
    launch = _launch_cluster if _clustered(q, d, ps) else _launch_decode
    out = launch(q, pool_k, pool_v, seq_lens, block_table, mp * ps, ps, mp,
                 sm_scale, soft_cap, name, k_scale, v_scale)
    count(name)
    return out


def check_int32(**tensors) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 for the kernel, got {t.dtype}")


# ---------------------------------------------------------------------------
# K7: the split-KV decode state, and its merge


def auto_n_split(seq_kv: int) -> int:
    """Default split count of :func:`decode_attention_state` (JAX
    ``auto_n_split``): 4, halved until it divides the cache length."""
    n = 4
    while n > 1 and seq_kv % n:
        n //= 2
    return n


def decode_states_ref(q, k, v, keep, n_split: int, *, sm_scale: float,
                      soft_cap: float = 0.0, p_dtype=None, k_scale=None,
                      v_scale=None):
    """Plain version of the state pass: the unnormalized (num, m, l) of each
    of ``n_split`` equal splits of the positions of ``k``/``v`` (B, Hkv, S,
    D) where ``keep`` (B, S) holds, for every query head of ``q`` (B, H, D).
    int8 codes come with per-position scales (B, Hkv, S).  A split with no
    kept position gives num = 0, m = -1e30, l = 0, as the JAX kernel's
    masked tile does.  Returns num (B, H, n_split, D), m and l (B, H,
    n_split)."""
    b, h, d = q.shape
    hk, s_len = k.shape[1], k.shape[2]
    g, sp = h // hk, s_len // n_split
    qs = _scaled_q(q, sm_scale).float().reshape(b, hk, g, 1, d)
    s = torch.matmul(qs, k.float().unsqueeze(2).transpose(-1, -2))  # (b,hk,g,1,S)
    if k_scale is not None:
        s = s * k_scale[:, :, None, None, :]
    if soft_cap:
        s = torch.tanh(s / soft_cap) * soft_cap
    s = s.reshape(b, hk, g, n_split, sp)
    keep = keep.reshape(b, 1, 1, n_split, sp)
    s = torch.where(keep, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep & (m > _NEG_INF / 2), torch.exp(s - m),
                    torch.zeros_like(s))
    l = p.sum(dim=-1)
    pr = p.to(p_dtype or v.dtype).float()
    if v_scale is not None:
        pr = pr * v_scale.reshape(b, hk, 1, n_split, sp)
    num = torch.einsum("bkgns,bknsd->bkgnd", pr,
                       v.float().reshape(b, hk, n_split, sp, d))
    return (num.reshape(b, h, n_split, d), m[..., 0].reshape(b, h, n_split),
            l.reshape(b, h, n_split))


def decode_attention_state_ref(q, k, v, kv_len, n_split: int, *,
                               sm_scale: float, soft_cap: float = 0.0):
    """Plain version of :func:`decode_attention_state`."""
    lens = _lens(kv_len, q.shape[0], q.device)
    keep = torch.arange(k.shape[2], device=q.device)[None, :] < lens[:, None]
    return decode_states_ref(q, k, v, keep, n_split, sm_scale=sm_scale,
                             soft_cap=soft_cap)


def paged_decode_attention_state_ref(q, pool_k, pool_v, block_table, seq_lens,
                                     *, sm_scale: float, soft_cap: float = 0.0,
                                     k_scale=None, v_scale=None):
    """Plain version of :func:`paged_decode_attention_state`: the pages
    gathered into a contiguous cache, one split per page."""
    ps, mp = pool_k.shape[2], block_table.shape[1]
    k, ks = gather_pages(pool_k, block_table, k_scale)
    v, vs = gather_pages(pool_v, block_table, v_scale)
    keep = torch.arange(mp * ps, device=q.device)[None, :] < seq_lens[:, None]
    return decode_states_ref(q, k, v, keep, mp, sm_scale=sm_scale,
                             soft_cap=soft_cap, p_dtype=q.dtype, k_scale=ks,
                             v_scale=vs)


def merge_decode_states(num, m, l):
    """Combine split states over the split axis (JAX
    ``merge_decode_states``, plain torch ops as JAX computes it in jnp):
    rescale each numerator and denominator by exp(m_i - m*) and sum.
    ``num`` (..., S, D), ``m``/``l`` (..., S); returns (num, m, l) with the
    split axis reduced to size 1.  Associative, so states merge in any
    grouping (splits, then ranks)."""
    m_star = m.amax(dim=-1, keepdim=True)
    scale = torch.exp(m - m_star)
    num = (num * scale[..., None]).sum(dim=-2, keepdim=True)
    l = (l * scale).sum(dim=-1, keepdim=True)
    return num, m_star, l


def safe_normalize_decode(num, l, dtype) -> torch.Tensor:
    """``num / l``, with rows of l == 0 (a sequence of length 0) zeros
    instead of 0 / 0 (JAX ``safe_normalize_decode``)."""
    return torch.where(l > 0, num / l.clamp_min(1e-38),
                       torch.zeros_like(num)).to(dtype)


def _launch_state(q, k, v, lens, table, capacity: int, page_size: int,
                  max_pages: int, n_split: int, chunk: int, sm_scale: float,
                  soft_cap: float, name: str, k_scale=None, v_scale=None):
    b, h, d = q.shape
    num = torch.empty((b, h, n_split, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h, n_split), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    err = build.library().tdt_decode_attention_state(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        _ptr(table), _ptr(k_scale), _ptr(v_scale), num.data_ptr(),
        m.data_ptr(), l.data_ptr(), b, h, k.shape[1], d, capacity, page_size,
        max_pages, n_split, chunk, sm_scale, float(soft_cap),
        KERNEL_DTYPES[q.dtype], _stream(q.device))
    build.check(err, name)
    count(name)
    return num, m, l


def decode_attention_state(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_len, *, n_split: int | None = None,
                           sm_scale: float | None = None,
                           soft_cap: float = 0.0, block_k: int | None = None):
    """Split-KV decode pass returning the mergeable softmax state (K7).

    ``q`` (B, H, D); ``k``/``v`` (B, Hkv, Skv, D); ``kv_len`` an int, 0-d or
    (B,) tensor of ragged lengths.  Split s covers [s * Skv / n_split,
    (s + 1) * Skv / n_split) (JAX's boundaries; ``n_split=None`` is
    :func:`auto_n_split`).  Returns num (B, H, n_split, D) unnormalized and
    m, l (B, H, n_split); merging any set of states with
    :func:`merge_decode_states` and dividing gives exact attention.
    ``block_k`` (the Pallas kv tile) has no meaning for K7, whose blocks
    stream a split in rows of 16-byte loads; it is accepted and not used."""
    del block_k
    b, h, d, hk = _check_decode_q(q, k, ("q", "k"))
    _check_tensors(("k", "v"), (k, v))
    if k.shape[0] != b or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q={tuple(q.shape)} k={tuple(k.shape)} "
                         f"v={tuple(v.shape)}")
    seq_kv = k.shape[2]
    n_split = auto_n_split(seq_kv) if n_split is None else int(n_split)
    if n_split < 1 or seq_kv % n_split:
        raise ValueError(f"Skv={seq_kv} not divisible by n_split={n_split}")
    sm_scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    if q.device.type == "cpu":
        return decode_attention_state_ref(q, k, v, kv_len, n_split,
                                          sm_scale=sm_scale, soft_cap=soft_cap)
    _check_kernel_shape(d, h // hk)
    lens = _lens(kv_len, b, q.device)
    return _launch_state(q, k, v, lens, None, seq_kv, 0, 0, n_split,
                         seq_kv // n_split, sm_scale, soft_cap,
                         "decode_attention_state")


def paged_decode_attention_state(q: torch.Tensor, pool_k: torch.Tensor,
                                 pool_v: torch.Tensor,
                                 block_table: torch.Tensor,
                                 seq_lens: torch.Tensor, *,
                                 sm_scale: float | None = None,
                                 soft_cap: float = 0.0,
                                 k_scale: torch.Tensor | None = None,
                                 v_scale: torch.Tensor | None = None):
    """Split-KV decode over a paged cache returning one mergeable state per
    logical page (K7; JAX ``paged_decode_attention_state``): arguments as
    :func:`paged_decode_attention`; returns num (B, H, max_pages, D) and m,
    l (B, H, max_pages), the page axis in place of the split axis.  Pages at
    or past a sequence's length give num = 0, m = -1e30, l = 0 and are never
    read.  int8 pools come with their (P, Hkv) f32 scales."""
    quantized = check_page_scales(pool_k, pool_v, k_scale, v_scale)
    b, h, d, hk = _check_decode_q(q, pool_k, ("q", "pool_k"))
    _check_tensors(("pool_k", "pool_v"), (pool_k, pool_v),
                   float_like=not quantized)
    _check_tensors(("block_table", "seq_lens"), (block_table, seq_lens),
                   float_like=False)
    if pool_v.shape != pool_k.shape:
        raise ValueError(f"pool_k {tuple(pool_k.shape)} != pool_v "
                         f"{tuple(pool_v.shape)}")
    if block_table.dim() != 2 or block_table.shape[0] != b \
            or tuple(seq_lens.shape) != (b,):
        raise ValueError(f"block_table {tuple(block_table.shape)} / seq_lens "
                         f"{tuple(seq_lens.shape)} inconsistent with B={b}")
    if block_table.device != q.device or seq_lens.device != q.device:
        raise ValueError("block_table and seq_lens must be on q's device")
    sm_scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    ps, mp = pool_k.shape[2], block_table.shape[1]
    if q.device.type == "cpu":
        return paged_decode_attention_state_ref(
            q, pool_k, pool_v, block_table, seq_lens, sm_scale=sm_scale,
            soft_cap=soft_cap, k_scale=k_scale, v_scale=v_scale)
    _check_kernel_shape(d, h // hk)
    check_int32(block_table=block_table, seq_lens=seq_lens)
    name = ("paged_decode_attention_state_int8" if quantized
            else "paged_decode_attention_state")
    return _launch_state(q, pool_k, pool_v, seq_lens, block_table, mp * ps,
                         ps, mp, mp, ps, sm_scale, soft_cap, name, k_scale,
                         v_scale)


# ---------------------------------------------------------------------------
# K8: one KV chunk folded into a carried attention state


def init_attention_state(b: int, h: int, seq_q: int, d: int, *, device=None):
    """A fresh (m, l, acc) state for :func:`flash_attention_chunk`: m
    -1e30, l and acc zeros, f32, on ``device`` (the current CUDA device by
    default; ``"cpu"`` for the plain versions)."""
    dev = resolve_device(device)
    return (torch.full((b, h, seq_q), _NEG_INF, dtype=torch.float32, device=dev),
            torch.zeros((b, h, seq_q), dtype=torch.float32, device=dev),
            torch.zeros((b, h, seq_q, d), dtype=torch.float32, device=dev))


def _offset(x, device):
    """An int offset, or a 0-d integer tensor on q's device."""
    if isinstance(x, torch.Tensor):
        if x.dim() != 0 or x.dtype.is_floating_point or x.device != device:
            raise ValueError(f"an offset tensor must be 0-d, integer and on "
                             f"{device}, got {tuple(x.shape)} {x.dtype} on {x.device}")
        return x
    return int(x)


def flash_attention_chunk_ref(q, k, v, state, q_offset, kv_offset, *,
                              causal: bool = True, sm_scale: float,
                              soft_cap: float = 0.0):
    """Plain version of :func:`flash_attention_chunk`: the whole chunk in
    one online-softmax step (JAX ``_tile_update`` over the chunk)."""
    b, h, sq, d = q.shape
    hk, sc = k.shape[1], k.shape[2]
    g = h // hk
    m, l, acc = (t.reshape(b, hk, g, sq, *t.shape[3:]) for t in state)
    qs = _scaled_q(q, sm_scale).float().reshape(b, hk, g, sq, d)
    s = torch.matmul(qs, k.float().unsqueeze(2).transpose(-1, -2))
    if soft_cap:
        s = torch.tanh(s / soft_cap) * soft_cap
    m_prev = m[..., None]
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)
        kpos = kv_offset + torch.arange(sc, device=q.device)
        keep = kpos[None, :] <= qpos[:, None]
        s = torch.where(keep, s, torch.full_like(s, _NEG_INF))
    m_cur = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_cur)
    if causal:
        p = torch.where(m_cur > _NEG_INF / 2, p, torch.zeros_like(p))
    alpha = torch.exp(m_prev - m_cur)
    l_cur = l[..., None] * alpha + p.sum(dim=-1, keepdim=True)
    acc = acc * alpha + torch.matmul(p.to(v.dtype).float(),
                                     v.float().unsqueeze(2))
    return (m_cur.reshape(b, h, sq), l_cur.reshape(b, h, sq),
            acc.reshape(b, h, sq, d))


def flash_attention_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          state, q_offset, kv_offset, *, causal: bool = True,
                          sm_scale: float | None = None,
                          soft_cap: float = 0.0, block_q: int = 512,
                          block_k: int = 512,
                          segment_ids_q: torch.Tensor | None = None,
                          segment_ids_kv: torch.Tensor | None = None):
    """Fold one KV chunk into a carried attention state (K8).

    ``q`` (B, H, Sq, D) at positions ``q_offset + [0, Sq)``; ``k``/``v``
    (B, Hkv, Sc, D) at ``kv_offset + [0, Sc)``; ``state`` (m, l, acc) from
    :func:`init_attention_state` or a previous call.  The offsets are ints
    or 0-d int32 tensors on q's device, which the kernel reads itself (no
    host sync).  Causal masking is by absolute position; a chunk wholly in
    the future of every query returns the state unchanged.  Returns the new
    state (new tensors: the one given is not changed); normalize it with
    :func:`finalize_attention_state` after the last chunk.  ``block_q`` and
    ``block_k`` (the Pallas tiles) have no meaning for K8, whose tiles are
    fixed; they are accepted and not used."""
    del block_q, block_k
    if segment_ids_q is not None or segment_ids_kv is not None:
        raise NotImplementedError(
            "segment_ids_q/segment_ids_kv (packed varlen chunks) belong to a "
            "later slice of the port")
    _check_tensors(("q", "k", "v"), (q, k, v))
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q={tuple(q.shape)} k={tuple(k.shape)} "
                         f"v={tuple(v.shape)}")
    b, h, sq, d = q.shape
    bk_, hk, sc, dk = k.shape
    if (bk_, dk) != (b, d):
        raise ValueError(f"shape mismatch: q={tuple(q.shape)} k={tuple(k.shape)}")
    if h % hk:
        raise ValueError(f"GQA requires H % Hkv == 0, got {h} % {hk}")
    m, l, acc = state
    _check_tensors(("m", "l", "acc"), (m, l, acc))
    if m.dtype != torch.float32 or tuple(m.shape) != (b, h, sq) \
            or l.shape != m.shape or tuple(acc.shape) != (b, h, sq, d) \
            or m.device != q.device:
        raise ValueError(f"state (m {tuple(m.shape)}, l {tuple(l.shape)}, acc "
                         f"{tuple(acc.shape)}) is not f32 (B, H, Sq) / "
                         f"(B, H, Sq, D) = ({b}, {h}, {sq}[, {d}]) on {q.device}")
    q_off, kv_off = _offset(q_offset, q.device), _offset(kv_offset, q.device)
    sm_scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    if q.device.type == "cpu":
        return flash_attention_chunk_ref(q, k, v, state, q_off, kv_off,
                                         causal=causal, sm_scale=sm_scale,
                                         soft_cap=soft_cap)
    _check_kernel_shape(d)
    offs = []
    for x in (q_off, kv_off):
        if isinstance(x, torch.Tensor):
            x = x if x.dtype == torch.int32 else x.to(torch.int32)
            offs.append((x, x.data_ptr(), 0))
        else:
            offs.append((None, None, x))
    m_out, l_out, acc_out = torch.empty_like(m), torch.empty_like(l), torch.empty_like(acc)
    err = build.library().tdt_flash_attention_chunk(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(), l.data_ptr(),
        acc.data_ptr(), m_out.data_ptr(), l_out.data_ptr(), acc_out.data_ptr(),
        offs[0][1], offs[1][1], b, h, hk, sq, sc, d, int(bool(causal)),
        offs[0][2], offs[1][2], sm_scale, float(soft_cap),
        KERNEL_DTYPES[q.dtype], _stream(q.device))
    build.check(err, "flash_attention_chunk")
    count("flash_attention_chunk")
    return m_out, l_out, acc_out


def finalize_attention_state(state, dtype) -> torch.Tensor:
    """Normalize a carried state into the attention output (B, H, Sq, D)
    (JAX ``finalize_attention_state``: acc / l; a row that saw no key has
    l = 0 and gives NaN there too)."""
    m, l, acc = state
    del m
    return (acc / l[..., None]).to(dtype)
