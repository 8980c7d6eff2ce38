"""Low-precision codecs: the int8 codec of the KV cache and the packed wire
message of the quantized all-to-all (counterpart of
``triton_distributed_tpu/lang/quant.py``).

**KV cache** (:func:`quantize_pages`): a block of values shares one f32
scale, chosen so that the block's absolute maximum maps to ``INT8_MAX``;
codes are ``round(x / scale)`` clipped to [-127, 127] (round half to even,
as ``jnp.round``).  ``SCALE_EPS`` keeps an all-zero block at a finite scale,
so 0 / 0 never happens and zeros round-trip exactly.  The KV cache applies
it per (page, head), a block being the (page_size, head_dim) rows of one
head in one page.

**Wire message** (:func:`pack_rows`, :func:`unpack_rows`): each row of H
values is quantized with one f32 scale (its absmax over ``E4M3_MAX`` or
``INT8_MAX``, plus ``SCALE_EPS``) into ``(..., H + SIDECAR)`` uint8: H
payload bytes (e4m3 or int8 codes), then the scale's 4 bytes little-endian,
then zeros to ``SIDECAR``.  One unpack serves both payload types.
:func:`pack_rows` launches K18 (``csrc/quant_pack.cu``, replacing the Pallas
``_pack_kernel``) for a CUDA tensor and takes the plain version
:func:`pack_rows_ref` for a CPU one.  The plain version is JAX's
``_pack_rows_xla`` bit for bit: IEEE divisions for the scale and the codes
(a division by a tensor, never by a Python scalar, which PyTorch's CUDA
kernels turn into a product with the reciprocal), e4m3 by round to nearest
even, int8 by ``round`` and a clamp.  K18 equals the plain version bit for
bit.  JAX's own Pallas kernel takes the scale as ``absmax * (1 / 448)``, one
ulp off the IEEE quotient in about 6 of 10 rows; against it the port is held
to the decoded envelope :func:`abs_error_bound`, as JAX holds its two
producers ("decoded equivalence, not byte equality").

Error envelopes, relative to the row absmax: e4m3 2^-4 (half an ulp at 3
mantissa bits near the max), int8 0.5 / 127, plus ``SCALE_EPS``.
"""

from __future__ import annotations

import torch

from ..core import build
from ..core.launches import count

E4M3_MAX = 448.0     # largest finite float8_e4m3fn value
INT8_MAX = 127.0     # symmetric int8 grid (-128 is not used)
SCALE_EPS = 1e-12    # keeps all-zero blocks and rows at a finite scale

# u8 lanes appended to a packed row: the first 4 carry the f32 scale
SIDECAR = 128
WIRE_DTYPES = ("bf16", "int8", "fp8")
_QMAX = {"fp8": E4M3_MAX, "int8": INT8_MAX}
_PAYLOAD = {"fp8": torch.float8_e4m3fn, "int8": torch.int8}
# K18's codes (csrc/quant_pack.cu)
_IN_CODES = {torch.float32: 0, torch.bfloat16: 1}
_WIRE_CODES = {"int8": 0, "fp8": 1}


def quantize_pages(vals: torch.Tensor):
    """``(codes, scale)``: int8 codes of ``vals`` (..., rows, cols) with one
    f32 scale per block of the last two axes; ``scale`` has ``vals``' shape
    without them."""
    xf = vals.float()
    scale = xf.abs().amax(dim=(-2, -1)) / INT8_MAX + SCALE_EPS
    codes = torch.round(xf / scale[..., None, None]).clamp_(-INT8_MAX, INT8_MAX)
    return codes.to(torch.int8), scale


def dequantize_pages(codes: torch.Tensor, scale: torch.Tensor,
                     dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_pages`: ``codes * scale`` in f32, cast to
    ``dtype``."""
    return (codes.float() * scale.float()[..., None, None]).to(dtype)


# ---------------------------------------------------------------------------
# the wire message


def is_quantized(wire_dtype: str) -> bool:
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"wire_dtype {wire_dtype!r} not in {WIRE_DTYPES}")
    return wire_dtype != "bf16"


def rel_error_bound(wire_dtype: str) -> float:
    """Worst |dequantized - x| / row absmax of one round trip."""
    return {"fp8": 2.0 ** -4, "int8": 0.5 / INT8_MAX, "bf16": 2.0 ** -8}[wire_dtype]


def abs_error_bound(absmax, wire_dtype: str):
    """The absolute per-element envelope of one round trip: the relative
    bound times the row absmax, plus ``SCALE_EPS`` (rows whose absmax sinks
    toward the epsilon flush to zero)."""
    return rel_error_bound(wire_dtype) * absmax + SCALE_EPS


def packed_width(h: int, wire_dtype: str) -> int:
    """Bytes of the wire message of an H-wide row."""
    return h + SIDECAR if is_quantized(wire_dtype) else 2 * h


def _divide(a: torch.Tensor, b) -> torch.Tensor:
    """``a / b`` as one IEEE division per element, ``b`` broadcast as a
    tensor of ``a``'s shape (a Python scalar divisor becomes a product with
    its reciprocal in PyTorch's CUDA kernels)."""
    if not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=a.dtype, device=a.device)
    return torch.div(a, b.expand_as(a).contiguous())


def quantize_rows(x: torch.Tensor, wire_dtype: str = "fp8", *, axis: int = -1):
    """Per-row quantization: ``(q, scale)``, ``scale`` f32 with ``axis``
    kept at size 1, ``q`` ``float8_e4m3fn`` or ``int8`` (JAX
    ``quantize_rows``, bit for bit)."""
    xf = x.float()
    absmax = xf.abs().amax(dim=axis, keepdim=True)
    scale = _divide(absmax, _QMAX[wire_dtype]) + SCALE_EPS
    y = _divide(xf, scale)
    if wire_dtype == "fp8":
        return y.to(torch.float8_e4m3fn), scale
    return torch.round(y).clamp_(-INT8_MAX, INT8_MAX).to(torch.int8), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_rows` (both payload types): ``q * scale``
    in f32, cast to ``dtype``."""
    return (q.float() * scale).to(dtype)


def pack_quantized(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The wire message of already quantized rows: payload bytes, the f32
    scale's 4 bytes, zeros to ``SIDECAR`` lanes."""
    lead = q.shape[:-1]
    sc = scale.float().reshape(*lead, 1).contiguous().view(torch.uint8)
    pad = torch.zeros((*lead, SIDECAR - 4), dtype=torch.uint8, device=q.device)
    return torch.cat([q.contiguous().view(torch.uint8), sc, pad], dim=-1)


def pack_rows_ref(x: torch.Tensor, wire_dtype: str = "fp8") -> torch.Tensor:
    """Plain version of K18, on any device: JAX ``_pack_rows_xla``."""
    return pack_quantized(*quantize_rows(x, wire_dtype))


def _check_wire(wire_dtype: str) -> None:
    if not is_quantized(wire_dtype):
        raise ValueError("pack_rows packs the quantized wire dtypes only; bf16 rows ship "
                         "unpacked")


def pack_rows(x: torch.Tensor, wire_dtype: str = "fp8") -> torch.Tensor:
    """Quantize rows (..., H) into the wire message (..., H + SIDECAR)
    uint8.  A CUDA tensor launches K18 (f32 or bf16 rows, H a multiple of
    16; else it raises), a CPU tensor takes :func:`pack_rows_ref`."""
    _check_wire(wire_dtype)
    if not x.is_cuda:
        return pack_rows_ref(x, wire_dtype)
    if x.dtype not in _IN_CODES:
        raise TypeError(f"K18 packs float32 or bfloat16 rows, not {x.dtype}")
    h = x.shape[-1]
    if h % 16:
        raise ValueError(f"H = {h}: K18 packs rows of a multiple of 16 values")
    x = x.contiguous()
    rows = x.numel() // max(h, 1)
    out = torch.empty((*x.shape[:-1], h + SIDECAR), dtype=torch.uint8, device=x.device)
    if rows:
        err = build.library().tdt_quant_pack(
            x.data_ptr(), out.data_ptr(), rows, h, _IN_CODES[x.dtype], _WIRE_CODES[wire_dtype],
            SCALE_EPS, torch.cuda.current_stream(x.device).cuda_stream)
        build.check(err, "quant_pack")
        count("quant_pack", (wire_dtype, rows, h))
    return out


def unpack_rows(u8: torch.Tensor, h: int, wire_dtype: str = "fp8",
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`pack_rows`: the payload and the scale split off the
    message, dequantized to ``out_dtype`` (JAX ``unpack_rows``; plain
    PyTorch ops on every device, as JAX leaves it to XLA)."""
    _check_wire(wire_dtype)
    q = u8[..., :h].view(_PAYLOAD[wire_dtype])
    scale = u8[..., h:h + 4].contiguous().view(torch.float32)
    return dequantize_rows(q, scale, out_dtype)
