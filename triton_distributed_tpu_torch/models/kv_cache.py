"""KV caches: preallocated tensors, updated in place.

Counterpart of ``triton_distributed_tpu/models/kv_cache.py`` at tp = 1, with
the same two layouts:

- :class:`KVCache`: contiguous (L, B, Hkv, max_len, D) blocks and one shared
  length ``kv_len`` (every sequence the same age), a 0-d int32 tensor on the
  cache's device as JAX's ``()`` int32 array is.  It is written in place and
  never read back to the host, so a CUDA graph that captures a step reads
  the length of each replay (``tools/aot.py``).
- :class:`PagedKVCache`: a physical page pool (L, P, Hkv, page_size, D), a
  per-sequence ``block_table`` (B, max_pages) int32 and ragged ``seq_lens``
  (B,) int32.  Decode reads it through the block-table kernels
  (``ops.attention.paged_decode_attention``, ``ops.fused_decode``).  With
  ``kv_dtype="int8"`` the pools hold int8 codes and ``k_scale``/``v_scale``
  (L, P, Hkv) f32 hold one scale per (layer, page, head), the
  ``lang.quant`` recipe; writes requantize the pages they touch and the
  decode kernels dequantize as they stream.

At tp = n (a mesh of co-located ranks, ``core/mesh.py``) the caches are
head-sharded as JAX's (``P(None, None, axis, ...)``, ``kv_cache.py:75,
227``): rank r holds kv heads ``[r Hkv / n, (r + 1) Hkv / n)``.  They are
kept rank-stacked with the rank folded into the batch, so that each is a
tp = 1 cache of n B sequences with Hkv / n heads, which the tp = 1 kernels
and writes serve unchanged, one launch for all ranks: a contiguous cache's
k/v are (L, n B, Hkv / n, max_len, D), rank r's sequences at rows
``[r B, (r + 1) B)``; a paged cache's pools are (L, n P, Hkv / n, ps, D),
rank r's pages at ``[r P, (r + 1) P)``, its block table (n B, max_pages)
holds each rank's copy of the table offset into that rank's pages, and
``seq_lens`` (n B,) each rank's copy of the lengths.  :func:`unshard_cache`
gives the JAX layout back; int8 pages at tp > 1 are not served yet.

The JAX package's arrays are immutable: its engine donates the cache buffers
at the jit boundary and rebuilds the stacked pool once per step through
``replace_layer_slices`` (``models/qwen.py:775``).  Here the pools are written
**in place** (the reference engine's own model, a preallocated cache mutated
by each step), and the functions below mutate and return the cache they are
given.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..core.utils import cdiv
from ..lang import quant


class PagePoolExhausted(RuntimeError):
    """A sequence needs a KV page its block table does not have.

    Raised by :func:`append_paged` when a sequence's write position has
    outgrown its pages (``seq_lens[b] >= max_pages * page_size``), instead of
    writing the token into a wrong page.  ``sequences`` names them."""

    def __init__(self, msg: str, *, sequences: tuple[int, ...] = (),
                 needed: int = 0, available: int = 0):
        self.sequences = tuple(sequences)
        self.needed = int(needed)
        self.available = int(available)
        super().__init__(msg)


@dataclasses.dataclass
class KVCache:
    """k/v: (L, B, Hkv, max_len, D); kv_len: valid positions, shared by all
    layers and sequences, a 0-d int32 tensor on k's device.  The length
    given here (an int, a tensor, or None for 0) is copied, so two caches
    never share one (``dataclasses.replace`` included); the writes below
    update it in place."""

    k: torch.Tensor
    v: torch.Tensor
    kv_len: torch.Tensor | None = None

    def __post_init__(self):
        n = 0 if self.kv_len is None else self.kv_len
        self.kv_len = torch.as_tensor(n, dtype=torch.int32).to(self.k.device).reshape(()).clone()


@dataclasses.dataclass
class PagedKVCache:
    """k/v: (L, P, Hkv, page_size, D) page pools; block_table: (B, max_pages)
    int32, logical page j of sequence b in pool page ``block_table[b, j]``;
    seq_lens: (B,) int32 ragged valid lengths, on the pools' device.
    k_scale/v_scale: (L, P, Hkv) f32 per-(page, head) scales of int8 pools,
    None for full-precision pools."""

    k: torch.Tensor
    v: torch.Tensor
    block_table: torch.Tensor
    seq_lens: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    @property
    def max_pages(self) -> int:
        return self.block_table.shape[1]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def _rank_heads(kv_heads: int, tp: int) -> int:
    if kv_heads % tp:
        raise ValueError(f"{kv_heads} kv heads do not divide among tp = {tp} ranks")
    return kv_heads // tp


def init_cache(num_layers: int, batch: int, kv_heads: int, max_length: int,
               head_dim: int, dtype=torch.bfloat16, *,
               device=None, tp: int = 1) -> KVCache:
    """A zeroed contiguous cache; at ``tp`` > 1 head-sharded and
    rank-folded (module docstring)."""
    shape = (num_layers, tp * batch, _rank_heads(kv_heads, tp), max_length, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def _resolve_kv_dtype(dtype, kv_dtype) -> tuple[torch.dtype, bool]:
    """(pool dtype, quantized?) from the ``kv_dtype`` knob: None keeps
    ``dtype``; "int8" (or ``torch.int8``) selects the quantized
    per-(page, head)-scale layout.  Other pool dtypes, which the JAX package
    stores as they are, have no decode kernel here and are refused."""
    if kv_dtype is None or kv_dtype == dtype:
        return dtype, False
    if kv_dtype in ("int8", torch.int8):
        return torch.int8, True
    raise ValueError(f"kv_dtype {kv_dtype!r} not served: None or 'int8'")


def kv_page_bytes(num_layers: int, kv_heads: int, page_size: int,
                  head_dim: int, dtype=torch.bfloat16, kv_dtype=None) -> int:
    """Bytes one physical page costs across all layers, k and v, the f32
    scales of an int8 pool included (the unit of the cache's capacity)."""
    pd, quantized = _resolve_kv_dtype(dtype, kv_dtype)
    per = 2 * num_layers * kv_heads * page_size * head_dim * pd.itemsize
    if quantized:
        per += 2 * num_layers * kv_heads * 4
    return per


def _init_scales(num_layers: int, pool_pages: int, kv_heads: int,
                 device) -> torch.Tensor:
    return torch.full((num_layers, pool_pages, kv_heads), quant.SCALE_EPS,
                      dtype=torch.float32, device=device)


def init_paged_cache(num_layers: int, batch: int, kv_heads: int,
                     max_length: int, head_dim: int, dtype=torch.bfloat16, *,
                     page_size: int = 64, device=None,
                     generator: torch.Generator | None = None,
                     kv_dtype=None, tp: int = 1) -> PagedKVCache:
    """Preallocate ``batch * (max_length // page_size)`` pages and a full
    block table.  With ``generator`` (a CPU generator) the (sequence,
    logical page) -> physical page map is a seeded random permutation, the
    fragmented layout a real page allocator produces; without it, the
    identity.  ``kv_dtype="int8"`` selects the quantized layout.  At ``tp``
    > 1 every rank gets its own pages and its copy of the table,
    head-sharded and rank-folded (module docstring)."""
    if max_length % page_size:
        raise ValueError(
            f"max_length {max_length} not divisible by page_size {page_size}")
    mp = max_length // page_size
    p = batch * mp
    pool_dtype, quantized = _resolve_kv_dtype(dtype, kv_dtype)
    if quantized and tp > 1:
        raise NotImplementedError(
            "int8 pages at tp > 1 (per-rank scales of the head-sharded pools) are not "
            "ported yet; use full-precision pages")
    hk = _rank_heads(kv_heads, tp)
    shape = (num_layers, tp * p, hk, page_size, head_dim)
    ids = (torch.randperm(p, generator=generator) if generator is not None
           else torch.arange(p))
    table = ids.to(torch.int32).reshape(batch, mp)
    return PagedKVCache(
        k=torch.zeros(shape, dtype=pool_dtype, device=device),
        v=torch.zeros(shape, dtype=pool_dtype, device=device),
        block_table=fold_table(table, tp, p).to(device),
        seq_lens=torch.zeros((tp * batch,), dtype=torch.int32, device=device),
        k_scale=_init_scales(num_layers, p, hk, device) if quantized else None,
        v_scale=_init_scales(num_layers, p, hk, device) if quantized else None,
    )


def fold_table(table: torch.Tensor, tp: int, pages: int) -> torch.Tensor:
    """Each rank's copy of a (B, max_pages) block table, into its own
    ``pages`` of the rank-folded pool: (tp B, max_pages)."""
    return torch.cat([table + r * pages for r in range(tp)])


def fold_heads(t: torch.Tensor, tp: int) -> torch.Tensor:
    """A JAX-layout (L, X, Hkv, ...) pool or cache cut into tp head shards,
    rank-folded: (L, tp X, Hkv / tp, ...)."""
    lead, x, hk = t.shape[0], t.shape[1], t.shape[2]
    t = t.reshape(lead, x, tp, hk // tp, *t.shape[3:]).transpose(1, 2)
    return t.reshape(lead, tp * x, hk // tp, *t.shape[4:]).contiguous()


def unfold_heads(t: torch.Tensor, tp: int) -> torch.Tensor:
    """The inverse of :func:`fold_heads`."""
    lead, hk = t.shape[0], t.shape[2]
    t = t.reshape(lead, tp, t.shape[1] // tp, hk, *t.shape[3:]).transpose(1, 2)
    return t.reshape(lead, t.shape[1], tp * hk, *t.shape[4:]).contiguous()


def unshard_cache(cache, tp: int):
    """A tp-rank cache in the JAX package's (global) layout: (L, B, Hkv,
    max_len, D) caches, or (L, P, Hkv, ps, D) pools with rank 0's table and
    lengths."""
    if tp == 1:
        return cache
    if isinstance(cache, PagedKVCache):
        b = cache.seq_lens.shape[0] // tp
        return PagedKVCache(k=unfold_heads(cache.k, tp), v=unfold_heads(cache.v, tp),
                            block_table=cache.block_table[:b].clone(),
                            seq_lens=cache.seq_lens[:b].clone())
    return KVCache(k=unfold_heads(cache.k, tp), v=unfold_heads(cache.v, tp),
                   kv_len=cache.kv_len)


# ---------------------------------------------------------------------------
# the int8 page codec


_quantize_pages = quant.quantize_pages        # (..., Hkv, ps, D) -> codes, (..., Hkv)
_dequantize_pages = quant.dequantize_pages


def _merge_token_page(q_pages: torch.Tensor, scales: torch.Tensor,
                      tok: torch.Tensor, offs: torch.Tensor):
    """The quantized token append on the one page each sequence touches:
    dequantize it, set the token at its in-page offset, zero the slots past
    it (a recycled page holds the previous tenant's bytes, which must not
    inflate the absmax), and requantize.  ``q_pages``: (B, Hkv, ps, D) int8;
    ``scales``: (B, Hkv); ``tok``: (B, Hkv, D); ``offs``: (B,).  Returns
    ``(codes, scale)``."""
    ps = q_pages.shape[-2]
    rows = torch.arange(offs.shape[0], device=offs.device)
    old = _dequantize_pages(q_pages, scales)
    old[rows, :, offs] = tok.float()
    keep = (torch.arange(ps, device=offs.device)[None, None, :, None]
            <= offs[:, None, None, None])
    return _quantize_pages(torch.where(keep, old, torch.zeros_like(old)))


def dequantize_pool(cache: PagedKVCache, dtype=torch.bfloat16) -> PagedKVCache:
    """A full-precision copy of a quantized cache (a test and reference
    path: it materializes the pool)."""
    if not cache.quantized:
        return cache
    return dataclasses.replace(
        cache, k=_dequantize_pages(cache.k, cache.k_scale, dtype),
        v=_dequantize_pages(cache.v, cache.v_scale, dtype),
        k_scale=None, v_scale=None)


def layer_scales(cache: PagedKVCache, layer: int) -> dict:
    """One layer's ``k_scale``/``v_scale`` as the decode kernels take them;
    empty for a full-precision cache."""
    if not cache.quantized:
        return {}
    return dict(k_scale=cache.k_scale[layer], v_scale=cache.v_scale[layer])


def layer_pool(cache: PagedKVCache, layer: int, dtype=None) -> tuple:
    """One layer's (k, v) pools in compute precision: the pools themselves
    for a full-precision cache, dequantized copies for int8."""
    k_l, v_l = cache.k[layer], cache.v[layer]
    if not cache.quantized:
        return (k_l, v_l) if dtype is None else (k_l.to(dtype), v_l.to(dtype))
    dt = dtype if dtype is not None else torch.bfloat16
    return (_dequantize_pages(k_l, cache.k_scale[layer], dt),
            _dequantize_pages(v_l, cache.v_scale[layer], dt))


# ---------------------------------------------------------------------------
# writes


def write_prefill(cache: KVCache, layer: int, k_new: torch.Tensor,
                  v_new: torch.Tensor) -> KVCache:
    """Write a prefill's (B, Hkv, S, D) at positions [0, S)."""
    s = k_new.shape[2]
    cache.k[layer, :, :, :s] = k_new
    cache.v[layer, :, :, :s] = v_new
    return cache


def write_prefill_paged(cache: PagedKVCache, layer: int, k_new: torch.Tensor,
                        v_new: torch.Tensor) -> PagedKVCache:
    """Scatter a prefill's (B, Hkv, S, D) into the pool at positions [0, S).
    A partial trailing page is zero-padded; its slots are masked by
    ``seq_lens`` and overwritten by later appends.  An int8 cache quantizes
    each written page with its own (page, head) scale."""
    b, hk, s, d = k_new.shape
    ps = cache.page_size
    npg = cdiv(s, ps)
    pages = cache.block_table[:, :npg].long()

    def paged_vals(vals):
        vals = F.pad(vals, (0, 0, 0, npg * ps - s))
        return vals.reshape(b, hk, npg, ps, d).permute(0, 2, 1, 3, 4)

    if cache.quantized:
        for pool, scale, vals in ((cache.k, cache.k_scale, k_new),
                                  (cache.v, cache.v_scale, v_new)):
            codes, sc = _quantize_pages(paged_vals(vals))
            pool[layer][pages] = codes
            scale[layer][pages] = sc
        return cache
    cache.k[layer][pages] = paged_vals(k_new).to(cache.k.dtype)
    cache.v[layer][pages] = paged_vals(v_new).to(cache.v.dtype)
    return cache


def _token_slots(block_table: torch.Tensor, seq_lens: torch.Tensor,
                 page_size: int):
    """(pool page, in-page offset) of each sequence's next position."""
    lens = seq_lens.long()
    pages = block_table.long().gather(1, (lens // page_size)[:, None])[:, 0]
    return pages, lens % page_size


def append_layer_quantized(pool_k_l: torch.Tensor, pool_v_l: torch.Tensor,
                           ksc_l: torch.Tensor, vsc_l: torch.Tensor,
                           block_table: torch.Tensor, seq_lens: torch.Tensor,
                           k_tok: torch.Tensor, v_tok: torch.Tensor):
    """The quantized ragged append on one layer's pools, in place:
    ``pool_*_l`` (P, Hkv, ps, D) int8, ``*sc_l`` (P, Hkv) f32, the new token
    ``k_tok``/``v_tok`` (B, Hkv, D) at position ``seq_lens[b]``.  Each
    sequence's one touched page is dequantized, merged and requantized
    (:func:`_merge_token_page`).  Returns the four tensors."""
    pages, offs = _token_slots(block_table, seq_lens, pool_k_l.shape[2])
    for pool, scale, tok in ((pool_k_l, ksc_l, k_tok), (pool_v_l, vsc_l, v_tok)):
        codes, sc = _merge_token_page(pool[pages], scale[pages], tok, offs)
        pool[pages] = codes
        scale[pages] = sc
    return pool_k_l, pool_v_l, ksc_l, vsc_l


def append_token(cache, layer: int, k_tok: torch.Tensor,
                 v_tok: torch.Tensor):
    """Write one decode token per sequence, (B, Hkv, D), at its position:
    the shared ``kv_len`` or each sequence's ``seq_lens[b]``.  Does not
    advance the length (the model advances once per step, after all
    layers) and reads nothing back to the host: the caller guarantees the
    position has a page (``Engine`` checks the request length up front;
    :func:`append_paged` checks on the host)."""
    if isinstance(cache, PagedKVCache):
        if cache.quantized:
            append_layer_quantized(cache.k[layer], cache.v[layer],
                                   cache.k_scale[layer], cache.v_scale[layer],
                                   cache.block_table, cache.seq_lens,
                                   k_tok, v_tok)
            return cache
        pages, offs = _token_slots(cache.block_table, cache.seq_lens,
                                   cache.page_size)
        cache.k[layer][pages, :, offs] = k_tok.to(cache.k.dtype)
        cache.v[layer][pages, :, offs] = v_tok.to(cache.v.dtype)
    else:
        # a 0-d tensor index would be read back to the host: index_copy_
        # takes the position as a (1,) device index
        pos = cache.kv_len.reshape(1).long()
        cache.k[layer].index_copy_(2, pos, k_tok.to(cache.k.dtype).unsqueeze(2))
        cache.v[layer].index_copy_(2, pos, v_tok.to(cache.v.dtype).unsqueeze(2))
    return cache


def append_paged(cache: PagedKVCache, layer: int, k_tok: torch.Tensor,
                 v_tok: torch.Tensor) -> PagedKVCache:
    """:func:`append_token` on a paged cache, after checking on the host
    that every sequence's position lies inside its block table; raises
    :class:`PagePoolExhausted` naming the sequences that outgrew it."""
    ps = cache.page_size
    limit = cache.max_pages * ps
    pos = cache.seq_lens.cpu()
    over = [int(b) for b in torch.nonzero(pos >= limit).flatten()]
    if over:
        raise PagePoolExhausted(
            f"append_paged: sequence(s) {over} at position(s) "
            f"{[int(pos[b]) for b in over]} have outgrown their block table "
            f"({cache.max_pages} pages x page_size {ps} = {limit} positions); "
            f"allocate pages (or preempt) first",
            sequences=tuple(over), needed=1, available=0)
    return append_token(cache, layer, k_tok, v_tok)


def advance(cache, steps: int):
    """Add ``steps`` to the length(s), in place."""
    if isinstance(cache, PagedKVCache):
        cache.seq_lens += steps
    else:
        cache.kv_len += steps
    return cache


def with_length(cache, length):
    """Set the valid length(s), in place.  ``length`` is an int or a tensor
    (a device scalar included: nothing is read back to the host).  For a
    paged cache a scalar broadcasts to every sequence and a (B,) tensor sets
    ragged lengths."""
    lens = cache.seq_lens if isinstance(cache, PagedKVCache) else cache.kv_len
    if isinstance(length, torch.Tensor):
        lens.copy_(length.to(torch.int32).expand_as(lens))
    else:
        lens.fill_(int(length))
    return cache


def reset(cache):
    return with_length(cache, 0)
