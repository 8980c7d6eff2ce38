"""Flop and byte counts of a kernel call, and its roofline time on the card
(counterpart of ``triton_distributed_tpu/obs/costs.py``; the ``matmul``
calculator, the overlapped GEMMs' (K14's one-shot form too), the decode
megakernels', the EP all-to-all's, the wire pack's and ``sol_ms`` are
ported, the others come with the kernels they describe).  Counts are per rank, as JAX's; a call on n
co-located ranks does n times the work on one card."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class KernelCost:
    flops: float
    bytes_accessed: float
    wire_bytes: float = 0.0   # bytes a rank sends its peers

    def scaled(self, k: float) -> "KernelCost":
        return KernelCost(self.flops * k, self.bytes_accessed * k, self.wire_bytes * k)

    def __add__(self, other: "KernelCost") -> "KernelCost":
        return KernelCost(self.flops + other.flops, self.bytes_accessed + other.bytes_accessed,
                          self.wire_bytes + other.wire_bytes)


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def matmul(m: int, n: int, k: int, dtype, out_dtype=None) -> KernelCost:
    """C[m, n] = A[m, k] @ B[k, n]: each operand read once, C written once."""
    ib, ob = _itemsize(dtype), _itemsize(out_dtype or dtype)
    return KernelCost(flops=2 * m * n * k,
                      bytes_accessed=ib * (m * k + k * n) + ob * m * n)


def ag_gemm(m_loc: int, k: int, n_loc: int, num_ranks: int, dtype,
            out_dtype=None) -> KernelCost:
    """AllGather-GEMM per rank: the product over the whole gathered A
    (n m_loc rows), the gathered copy written, and (n - 1) A shards sent on
    the ring (JAX ``costs.ag_gemm``)."""
    n = num_ranks
    mm = matmul(n * m_loc, n_loc, k, dtype, out_dtype)
    wire = (n - 1) * m_loc * k * _itemsize(dtype)
    return KernelCost(flops=mm.flops,
                      bytes_accessed=mm.bytes_accessed + n * m_loc * k * _itemsize(dtype) + wire,
                      wire_bytes=wire)


def gemm_rs(m_loc: int, k_loc: int, n_dim: int, num_ranks: int, dtype,
            out_dtype=None) -> KernelCost:
    """GEMM-ReduceScatter per rank: n chunk products over the local K shard,
    the travelling partial's n - 1 adds, each forwarded partial one hop
    (JAX ``costs.gemm_rs``)."""
    n = num_ranks
    ob = _itemsize(out_dtype or dtype)
    mm = matmul(n * m_loc, n_dim, k_loc, dtype, out_dtype)
    wire = (n - 1) * m_loc * n_dim * ob
    return KernelCost(flops=mm.flops + (n - 1) * m_loc * n_dim,
                      bytes_accessed=mm.bytes_accessed + 2 * (n - 1) * m_loc * n_dim * ob + wire,
                      wire_bytes=wire)


def one_shot_reduce(m: int, n_dim: int, num_ranks: int, out_dtype) -> KernelCost:
    """The one-shot exchange per rank after a product (K14's and K15's
    one-shot forms, K11's one-shot body): the rounded (m, n_dim) partial
    written once and read once, sent into a slot on each of the n - 1
    peers, the n slots read and summed, the result written."""
    n, ob = num_ranks, _itemsize(out_dtype)
    elems = m * n_dim
    wire = (n - 1) * elems * ob
    return KernelCost(flops=(n - 1) * elems,
                      bytes_accessed=2 * elems * ob + 2 * wire + n * elems * ob + elems * ob,
                      wire_bytes=wire)


def gemm_ar(m_loc: int, k_loc: int, n_dim: int, num_ranks: int, dtype,
            out_dtype=None, *, one_shot: bool = False) -> KernelCost:
    """GEMM-AllReduce per rank.  The ring form: the GEMM-RS phase plus the
    AllGather ring that returns every reduced chunk to every rank (JAX
    ``costs.gemm_ar``).  The one-shot form (``one_shot``): the whole
    (n m_loc, n_dim) product, then :func:`one_shot_reduce`."""
    n = num_ranks
    ob = _itemsize(out_dtype or dtype)
    if one_shot:
        mm = matmul(n * m_loc, n_dim, k_loc, dtype, out_dtype)
        red = one_shot_reduce(n * m_loc, n_dim, n, out_dtype or dtype)
        return KernelCost(mm.flops, mm.bytes_accessed - ob * n * m_loc * n_dim, 0.0) + red
    rs = gemm_rs(m_loc, k_loc, n_dim, n, dtype, out_dtype)
    ag_wire = (n - 1) * m_loc * n_dim * ob
    return KernelCost(flops=rs.flops,
                      bytes_accessed=rs.bytes_accessed + 2 * ag_wire,
                      wire_bytes=rs.wire_bytes + ag_wire)


def decode_attention(b: int, h: int, hk: int, seq_kv: int, d: int, kv_dtype) -> KernelCost:
    """One token against a (B, Hkv, seq_kv, D) cache: K and V streamed
    once, q read and the output written (JAX ``costs.decode_attention``)."""
    ib = _itemsize(kv_dtype)
    scores = b * h * seq_kv
    return KernelCost(flops=4 * scores * d,
                      bytes_accessed=2 * b * hk * seq_kv * d * ib + 2 * b * h * d * ib)


def fused_attn_decode(b: int, k_dim: int, h: int, hk: int, seq_kv: int, d: int,
                      kv_dtype) -> KernelCost:
    """The attention megakernel (K4) per rank: the qkv product (its weight
    read once, the activation rows read), the token's K/V slots written,
    and the decode over the cache (JAX ``costs.fused_attn_decode``)."""
    ib = _itemsize(kv_dtype)
    qkv_cols = (h + 2 * hk) * d
    att = decode_attention(b, h, hk, seq_kv, d, kv_dtype)
    return KernelCost(flops=att.flops + 2 * b * k_dim * qkv_cols,
                      bytes_accessed=att.bytes_accessed
                      + ib * (k_dim * qkv_cols + b * k_dim + 2 * b * hk * d))


def fused_mlp_ar(b: int, k_in: int, k_loc: int, n_dim: int, num_ranks: int, dtype,
                 out_dtype=None, *, swiglu: bool = True, one_shot: bool = False) -> KernelCost:
    """K15 per rank: [the gate/up product and SwiGLU when ``swiglu``] and
    the down (or o-proj) product, then the reduction.  The ring form: the
    chunk products, the travelling partials' adds, and 2 (n - 1) / n of the
    (B, n_dim) output on the ring's two phases (JAX ``costs.fused_mlp_ar``).
    The one-shot form (``one_shot``): the whole product, then
    :func:`one_shot_reduce`."""
    n = num_ranks
    ob = _itemsize(out_dtype or dtype)
    dn = matmul(b, n_dim, k_loc, dtype, out_dtype)
    pre = KernelCost(0.0, 0.0)
    if swiglu:
        up = matmul(b, 2 * k_loc, k_in, dtype, out_dtype)
        pre = KernelCost(up.flops + 3 * b * k_loc, up.bytes_accessed + 3 * b * k_loc * ob)
    if one_shot:
        return (pre + KernelCost(dn.flops, dn.bytes_accessed - ob * b * n_dim)
                + one_shot_reduce(b, n_dim, n, out_dtype or dtype))
    flops = dn.flops + (n - 1) * b * (n_dim // max(n, 1))
    wire = 2 * (n - 1) * b * (n_dim // max(n, 1)) * ob
    return pre + KernelCost(flops=flops, bytes_accessed=dn.bytes_accessed + 2 * wire,
                            wire_bytes=wire)


def persistent_decode(layers: int, b: int, k_dim: int, h: int, hk: int, seq_kv: int,
                      d: int, f_loc: int, num_ranks: int, kv_dtype) -> KernelCost:
    """K16 per rank: L x (K4's cell, the o-proj's K15 instance and the
    MLP's), h, hk and f_loc a rank's (JAX ``costs.persistent_decode``)."""
    att = fused_attn_decode(b, k_dim, h, hk, seq_kv, d, kv_dtype)
    oproj = fused_mlp_ar(b, h * d, h * d, k_dim, num_ranks, kv_dtype, swiglu=False)
    mlp = fused_mlp_ar(b, k_dim, f_loc, k_dim, num_ranks, kv_dtype, swiglu=True)
    return (att + oproj + mlp).scaled(layers)


def all_to_all(rows: int, row_bytes: int) -> KernelCost:
    """The EP all-to-all (K17) over all ranks: the ``rows`` real rows of
    ``row_bytes`` each, read once from the source and written once into a
    zone.  JAX's ``costs.all_to_all(n * z, ...)`` charges the zones'
    capacity; this counts the rows the data moves (wire: every row, as
    JAX's)."""
    return KernelCost(flops=0, bytes_accessed=2 * rows * row_bytes, wire_bytes=rows * row_bytes)


def quant_pack(rows: int, h: int, dtype) -> KernelCost:
    """The wire pack (K18): the rows read once, the (H + 128)-byte messages
    written once; an absmax, a division and a conversion an element."""
    from ..lang import quant

    return KernelCost(flops=3 * rows * h,
                      bytes_accessed=rows * h * _itemsize(dtype)
                      + rows * quant.packed_width(h, "fp8"))


def sol_ms(cost: KernelCost, dtype=torch.bfloat16) -> float:
    """Roofline time of ``cost`` on one card, in ms: the larger of the flops
    over the tensor-core (or, for f32, the FMA) peak and the bytes over the
    memory rate (``tools.perf_model.H100_SXM``, the card the port is built
    for)."""
    from ..tools import perf_model

    spec = perf_model.H100_SXM
    t_flops = cost.flops / (spec.tflops(dtype) * 1e12)
    t_mem = cost.bytes_accessed / (spec.hbm_gbps * 1e9)
    return max(t_flops, t_mem) * 1e3
