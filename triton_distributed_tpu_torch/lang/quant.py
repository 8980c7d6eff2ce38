"""The symmetric int8 codec of the KV cache (counterpart of the per-block
recipe in ``triton_distributed_tpu/lang/quant.py``).

A block of values shares one f32 scale, chosen so that the block's absolute
maximum maps to ``INT8_MAX``; codes are ``round(x / scale)`` clipped to
[-127, 127] (round half to even, as ``jnp.round``).  ``SCALE_EPS`` keeps an
all-zero block at a finite scale, so 0 / 0 never happens and zeros
round-trip exactly.  The KV cache applies it per (page, head), a block
being the (page_size, head_dim) rows of one head in one page.  The packed
collective wire format and its kernel belong to a later slice.
"""

from __future__ import annotations

import torch

INT8_MAX = 127.0     # symmetric int8 grid (-128 is not used)
SCALE_EPS = 1e-12    # keeps all-zero blocks at a finite scale


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
