"""KV caches: preallocated tensors, updated in place.

Counterpart of ``triton_distributed_tpu/models/kv_cache.py`` at tp = 1, with
the same two layouts:

- :class:`KVCache`: contiguous (L, B, Hkv, max_len, D) blocks and one shared
  length ``kv_len`` (every sequence the same age).
- :class:`PagedKVCache`: a physical page pool (L, P, Hkv, page_size, D), a
  per-sequence ``block_table`` (B, max_pages) int32 and ragged ``seq_lens``
  (B,) int32.  Decode reads it through the block-table kernel
  (``ops.attention.paged_decode_attention``).

The JAX package's arrays are immutable: its engine donates the cache buffers
at the jit boundary and rebuilds the stacked pool once per step through
``replace_layer_slices`` (``models/qwen.py:775``).  Here the pools are written
**in place** (the reference engine's own model, a preallocated cache mutated
by each step), and the functions below mutate and return the cache they are
given.  Only full-precision pools are served in this slice; the int8 pool
with per-(page, head) scales comes later.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..core.utils import cdiv


@dataclasses.dataclass
class KVCache:
    """k/v: (L, B, Hkv, max_len, D); kv_len: valid positions, shared by all
    layers and sequences (a host int: it never needs a device read)."""

    k: torch.Tensor
    v: torch.Tensor
    kv_len: int = 0


@dataclasses.dataclass
class PagedKVCache:
    """k/v: (L, P, Hkv, page_size, D) page pools; block_table: (B, max_pages)
    int32, logical page j of sequence b in pool page ``block_table[b, j]``;
    seq_lens: (B,) int32 ragged valid lengths, on the pools' device."""

    k: torch.Tensor
    v: torch.Tensor
    block_table: torch.Tensor
    seq_lens: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    @property
    def max_pages(self) -> int:
        return self.block_table.shape[1]


def init_cache(num_layers: int, batch: int, kv_heads: int, max_length: int,
               head_dim: int, dtype=torch.bfloat16, *,
               device=None) -> KVCache:
    shape = (num_layers, batch, kv_heads, max_length, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def init_paged_cache(num_layers: int, batch: int, kv_heads: int,
                     max_length: int, head_dim: int, dtype=torch.bfloat16, *,
                     page_size: int = 64, device=None,
                     generator: torch.Generator | None = None,
                     kv_dtype=None) -> PagedKVCache:
    """Preallocate ``batch * (max_length // page_size)`` pages and a full
    block table.  With ``generator`` (a CPU generator) the (sequence,
    logical page) -> physical page map is a seeded random permutation, the
    fragmented layout a real page allocator produces; without it, the
    identity."""
    if kv_dtype is not None:
        raise NotImplementedError(
            "kv_dtype (the int8 page pool) belongs to a later slice of the port")
    if max_length % page_size:
        raise ValueError(
            f"max_length {max_length} not divisible by page_size {page_size}")
    mp = max_length // page_size
    p = batch * mp
    shape = (num_layers, p, kv_heads, page_size, head_dim)
    ids = (torch.randperm(p, generator=generator) if generator is not None
           else torch.arange(p))
    return PagedKVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        block_table=ids.to(torch.int32).reshape(batch, mp).to(device),
        seq_lens=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


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
    ``seq_lens`` and overwritten by later appends."""
    b, hk, s, d = k_new.shape
    ps = cache.page_size
    npg = cdiv(s, ps)
    pages = cache.block_table[:, :npg].long()

    def paged_vals(vals):
        vals = F.pad(vals, (0, 0, 0, npg * ps - s))
        return vals.reshape(b, hk, npg, ps, d).permute(0, 2, 1, 3, 4)

    cache.k[layer][pages] = paged_vals(k_new).to(cache.k.dtype)
    cache.v[layer][pages] = paged_vals(v_new).to(cache.v.dtype)
    return cache


def append_token(cache, layer: int, k_tok: torch.Tensor,
                 v_tok: torch.Tensor):
    """Write one decode token per sequence, (B, Hkv, D), at its position:
    the shared ``kv_len`` or each sequence's ``seq_lens[b]``.  Does not
    advance the length (the model advances once per step, after all
    layers)."""
    if isinstance(cache, PagedKVCache):
        lens = cache.seq_lens.long()
        ps = cache.page_size
        pages = cache.block_table.long().gather(1, (lens // ps)[:, None])[:, 0]
        offs = lens % ps
        cache.k[layer][pages, :, offs] = k_tok.to(cache.k.dtype)
        cache.v[layer][pages, :, offs] = v_tok.to(cache.v.dtype)
    else:
        cache.k[layer, :, :, cache.kv_len] = k_tok
        cache.v[layer, :, :, cache.kv_len] = v_tok
    return cache


def advance(cache, steps: int):
    if isinstance(cache, PagedKVCache):
        cache.seq_lens += steps
    else:
        cache.kv_len += int(steps)
    return cache


def with_length(cache, length):
    """Set the valid length(s).  For a paged cache a scalar broadcasts to
    every sequence and a (B,) tensor sets ragged lengths."""
    if isinstance(cache, PagedKVCache):
        if isinstance(length, torch.Tensor):
            cache.seq_lens.copy_(length.to(torch.int32).expand_as(cache.seq_lens))
        else:
            cache.seq_lens.fill_(int(length))
    else:
        cache.kv_len = int(length)
    return cache


def reset(cache):
    return with_length(cache, 0)
