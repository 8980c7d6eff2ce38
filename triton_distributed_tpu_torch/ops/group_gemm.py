"""Grouped (per-expert) GEMM of expert-sorted rows (counterpart of
``triton_distributed_tpu/ops/group_gemm.py``).

:func:`grouped_matmul` launches K5 (``csrc/group_gemm.cu``), which replaces
the Pallas ``_grouped_matmul_kernel``.  It serves every product the JAX MoE
path hands to ``lax.ragged_dot`` or to ``grouped_matmul``: the port has no
``ragged_dot`` and no autotuner yet, so K5 is the one implementation on the
card, and choosing per shape between it and another backend comes with the
autotuner's port.  Its plain version :func:`grouped_matmul_ref` is a loop
over the groups with f32 accumulation; the wrapper takes it only for CPU
tensors.  A CUDA tensor launches K5 or raises.  One launch per product,
counted under ``"grouped_matmul"`` with its (T, K, N) as the form;
``splits`` stays on the device.  From :data:`SMALL_T` rows on, K5 runs its
prefill form: ``wgmma`` on TMA loads over a persistent walk of per-group
work units (:func:`..ops.swizzle.grouped_work_units`); below, its decode
form, 16-row ``mma.sync`` tiles on the slot schedule of
:func:`..ops.swizzle.grouped_tile_schedule`.  ``ag_group_gemm`` and ``moe_reduce_rs``,
the collectives around it, come with the multi-GPU slice of the port: at
one rank they gather and reduce nothing, and ``layers.moe`` calls
:func:`grouped_matmul` directly.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import build
from ..core.launches import count
from ..core.utils import cdiv
from .attention import KERNEL_DTYPES, _check_tensors, _stream, check_int32


@dataclasses.dataclass(frozen=True)
class GroupGemmConfig:
    """K5's tile: ``bm`` rows (one m-tile), ``bn`` output columns a block,
    ``bk`` the depth of one shared-memory stage.  The JAX config's
    ``vmem_limit`` has no meaning on Hopper."""

    bm: int = 128
    bn: int = 256
    bk: int = 64


DECODE_CONFIG = GroupGemmConfig(16, 64, 64)     # a few rows an expert
PREFILL_CONFIG = GroupGemmConfig(128, 256, 64)  # hundreds of rows an expert
F32_CONFIG = GroupGemmConfig(32, 64, 16)        # scalar f32, parity only
# the forms K5 is built for, by input dtype, with what a block's shared
# memory holds while it derives its work: the slot forms (decode, f32) the
# largest E + cdiv(T, bm), the unit walk (prefill, UNIT_CONFIGS) the largest E
KERNEL_CONFIGS = {
    torch.bfloat16: {DECODE_CONFIG: 11520, PREFILL_CONFIG: 1024},
    torch.float32: {F32_CONFIG: 4096},
}
UNIT_CONFIGS = frozenset({PREFILL_CONFIG})
SMALL_T = 1024   # below this many rows the decode tile is the default


def default_config(t: int, dtype: torch.dtype) -> GroupGemmConfig:
    if dtype == torch.float32:
        return F32_CONFIG
    return DECODE_CONFIG if t < SMALL_T else PREFILL_CONFIG


def kernel_config(t: int, e: int, n_dim: int, dtype: torch.dtype,
                  config: GroupGemmConfig | None = None) -> GroupGemmConfig:
    """The form K5 runs for T = ``t`` rows, ``e`` groups and ``n_dim``
    columns: ``config``, or :func:`default_config`.  Raises for a config
    with no kernel of ``dtype`` and for shapes past what it holds."""
    cfg = config or default_config(t, dtype)
    tiles = KERNEL_CONFIGS.get(dtype, {})
    if cfg not in tiles:
        raise ValueError(f"{cfg} has no {dtype} kernel (built for {list(tiles)})")
    if cfg in UNIT_CONFIGS:
        units = (cdiv(t, cfg.bm) + e) * cdiv(n_dim, cfg.bn)
        over = e > tiles[cfg] or units >= 2 ** 31
    else:
        over = e + cdiv(t, cfg.bm) > min(tiles[cfg], 65535)
    if over:
        raise ValueError(f"{t} rows and {e} groups exceed what K5 holds with {cfg}")
    return cfg


def _check(x_sorted, w, splits):
    t, k = x_sorted.shape
    e, k2, n_dim = w.shape
    if k2 != k:
        raise ValueError(f"inner dims mismatch: {tuple(x_sorted.shape)} @ "
                         f"{tuple(w.shape)}")
    if tuple(splits.shape) != (e,):
        raise ValueError(f"splits {tuple(splits.shape)} != (E,) = ({e},)")
    return t, k, e, n_dim


def grouped_matmul_ref(x_sorted: torch.Tensor, w: torch.Tensor,
                       splits: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """Plain version of :func:`grouped_matmul`: one f32 product per group
    over its rows, rounded to ``out_dtype``; rows past ``sum(splits)`` stay
    zero.  It reads ``splits`` on the host."""
    t, _, e, n_dim = _check(x_sorted, w, splits)
    out_dtype = out_dtype or x_sorted.dtype
    out = torch.zeros((t, n_dim), dtype=out_dtype, device=x_sorted.device)
    start = 0
    for g, n in enumerate(splits.tolist()):
        if n:
            out[start:start + n] = torch.matmul(
                x_sorted[start:start + n].float(), w[g].float()).to(out_dtype)
        start += n
    return out


def grouped_matmul(x_sorted: torch.Tensor, w: torch.Tensor,
                   splits: torch.Tensor, *,
                   config: GroupGemmConfig | None = None,
                   out_dtype=None) -> torch.Tensor:
    """(T, K) expert-sorted rows x (E, K, N) weights -> (T, N): row r below
    ``sum(splits)`` gets ``x_sorted[r] @ w[g]`` for the group g holding it
    (``splits`` (E,) int32 rows per group, in order from row 0), rows past
    it are zeros.  f32 accumulation, the result in ``out_dtype`` (x's by
    default; bf16 input may also give f32).  ``config`` picks K5's form
    (:data:`KERNEL_CONFIGS`; by default by T and dtype,
    :func:`kernel_config`); on the CPU it is not used."""
    _check_tensors(("x_sorted", "w"), (x_sorted, w))
    _check_tensors(("splits",), (splits,), float_like=False)
    if x_sorted.dim() != 2 or w.dim() != 3:
        raise ValueError(f"x_sorted must be (T, K) and w (E, K, N), got "
                         f"{tuple(x_sorted.shape)} and {tuple(w.shape)}")
    t, k, e, n_dim = _check(x_sorted, w, splits)
    if splits.device != x_sorted.device:
        raise ValueError(f"splits is on {splits.device}, x_sorted on "
                         f"{x_sorted.device}")
    out_dtype = out_dtype or x_sorted.dtype
    if out_dtype not in (x_sorted.dtype, torch.float32):
        raise TypeError(f"out_dtype {out_dtype} must be x's dtype or float32")
    if x_sorted.device.type == "cpu":
        return grouped_matmul_ref(x_sorted, w, splits, out_dtype=out_dtype)
    check_int32(splits=splits)
    if k % 8 or n_dim % 8:
        raise ValueError(f"K = {k} and N = {n_dim} must be multiples of 8 for "
                         "the kernel")
    if t == 0:
        return torch.empty((0, n_dim), dtype=out_dtype, device=x_sorted.device)
    cfg = kernel_config(t, e, n_dim, x_sorted.dtype, config)
    out = torch.empty((t, n_dim), dtype=out_dtype, device=x_sorted.device)
    err = build.library().tdt_grouped_matmul(
        x_sorted.data_ptr(), w.data_ptr(), splits.data_ptr(), out.data_ptr(),
        t, k, n_dim, e, cfg.bm, cfg.bn, cfg.bk, KERNEL_DTYPES[x_sorted.dtype],
        KERNEL_DTYPES[out_dtype], _stream(x_sorted.device))
    build.check(err, "grouped_matmul")
    count("grouped_matmul", (t, k, n_dim))
    return out

