"""triton_distributed_tpu_torch: the PyTorch/CUDA port of the JAX package
``triton_distributed_tpu``, for NVIDIA Hopper GPUs.

The JAX package beside it stays the reference; this package imports neither
JAX nor any module of it.  It serves Qwen3 decoders, dense (Qwen3-8B) and
MoE (Qwen3-30B-A3B), on one NVIDIA Hopper GPU at tp = 1 (and at tp = n on
co-located ranks, below):
prefill, then decode on a contiguous or a paged KV cache, with
full-precision or int8 pages, in ``decode_mode`` "psum" (the per-kernel
chain), "fused" (one attention megakernel per layer on a paged cache) or
"persistent" (every layer of a step in one launch, :func:`persistent_decode_step`).
Attention and the MoE expert products run through hand-written CUDA kernels
(``csrc/``), built by ``nvcc`` for ``sm_90a`` at first use; every other
product of the model is ``torch.matmul``.

Local ops beside the serving path: :func:`matmul`, the tuned GEMM, which
weighs the hand-written tiled GEMM against cuBLAS per shape through the
contextual autotuner (``tune``: :func:`tuned_matmul`,
:func:`fresh_tune_matmul`); and the state-carrying attention passes that
sequence parallelism folds: :func:`decode_attention_state` and
:func:`paged_decode_attention_state` with :func:`merge_decode_states`, and
:func:`flash_attention_chunk` between :func:`init_attention_state` and
:func:`finalize_attention_state`.

Collectives (``comm``) on a mesh of ranks co-located on one card
(:func:`make_mesh`, the rank-stacked layout of :func:`shard` and
:func:`unshard`; what every rank holds whole is held once, unstacked):
``comm.all_gather`` (K9), ``comm.reduce_scatter`` (K10) and
``comm.all_reduce`` (K11), and the overlapped GEMMs :func:`ag_gemm` (K12),
:func:`gemm_rs` (K13) and :func:`gemm_ar` (K14), each one cooperative
launch over every rank, on the signal pads and symmetric buffers of
``core/symm.py``.  Dense Qwen3 runs on such a mesh at tp = n
(``Engine.build(config, mesh=make_mesh({"tp": 4}))``): prefill on K12 and
K13, decode in "psum", "ar" (K11), "gemm_ar" (K14), "fused" (K4 for every
rank in one launch, the reductions on :func:`fused_linear_ar` and
:func:`fused_mlp_ar`, K15) or "persistent" (K16).  Qwen3-MoE runs there
under expert parallelism (``moe_strategy="ep"``): each prefill MLP through
the EP all-to-all, :func:`ep_dispatch` and :func:`ep_combine` (K17), with
``moe_fp8_wire`` on rows packed by :func:`pack_rows` (K18); each decode
step's MLP on the replicated batch.  :class:`AllGatherLayer` gathers into
two parity-slot workspaces (K9).

Entry points run on CUDA unless the caller passes ``device="cpu"``, where
the kernels' plain PyTorch versions run instead.  Without CUDA and without
that request they raise.
"""

from . import comm
from .comm.all_to_all import AllToAllConfig, ep_combine, ep_dispatch
from .core.launches import launch_counts, launch_forms, reset_launch_counts
from .core.mesh import (DP_AXIS, EP_AXIS, PP_AXIS, SP_AXIS, TP_AXIS, make_mesh,
                        shard, unshard)
from .core.platform import card_identity, device_kind, init_seed, resolve_device
from .core.symm import SymmetricBuffer, symm_buffer, symm_signal
from .core.utils import assert_allclose, cdiv, clip_block, perf_func
from .lang.quant import pack_rows, unpack_rows
from .layers.allgather_layer import AllGatherLayer
from .layers.moe import MoEMLP, MoEParams
from .layers.norm import rms_norm
from .models.config import QWEN3_8B, QWEN3_30B_A3B, ModelConfig
from .models.convert import from_jax_cache, from_jax_params, reblock
from .models.engine import Engine, sample_token
from .models.kv_cache import (
    KVCache,
    PagedKVCache,
    PagePoolExhausted,
    init_cache,
    init_paged_cache,
    kv_page_bytes,
    unshard_cache,
)
from .models.qwen import Qwen3, QwenParams
from .ops.attention import (
    auto_n_split,
    decode_attention,
    decode_attention_state,
    finalize_attention_state,
    flash_attention,
    flash_attention_chunk,
    init_attention_state,
    merge_decode_states,
    paged_decode_attention,
    paged_decode_attention_state,
)
from .ops.ag_gemm import ag_gemm
from .ops.fused_decode import fused_attn_decode, fused_linear_ar, fused_mlp_ar
from .ops.gemm_ar import gemm_ar
from .ops.persistent_decode import (StackedDecodeParams, decode_bundle, persistent_decode_step,
                                    stack_decode_params)
from .ops.gemm_rs import gemm_rs
from .ops.group_gemm import GroupGemmConfig, grouped_matmul
from .ops.matmul import matmul, matmul_callable
from .ops.rope import apply_rope, apply_rope_at, rope_freqs
from .tune import LibraryBackend, fresh_tune_matmul, tuned_matmul

__all__ = [
    "AllGatherLayer", "AllToAllConfig", "ep_combine", "ep_dispatch", "pack_rows",
    "unpack_rows",
    "DP_AXIS", "EP_AXIS", "PP_AXIS", "SP_AXIS", "SymmetricBuffer", "TP_AXIS",
    "comm", "make_mesh", "shard", "symm_buffer", "symm_signal", "unshard",
    "ag_gemm", "gemm_ar", "gemm_rs",
    "StackedDecodeParams", "decode_bundle", "persistent_decode_step", "stack_decode_params",
    "reblock", "unshard_cache",
    "Engine", "GroupGemmConfig", "KVCache", "LibraryBackend", "MoEMLP",
    "MoEParams", "ModelConfig", "PagePoolExhausted", "PagedKVCache",
    "QWEN3_30B_A3B", "QWEN3_8B", "Qwen3", "QwenParams", "apply_rope",
    "apply_rope_at", "assert_allclose", "auto_n_split", "card_identity",
    "cdiv", "clip_block", "decode_attention", "decode_attention_state",
    "device_kind", "finalize_attention_state", "flash_attention",
    "flash_attention_chunk", "fresh_tune_matmul", "from_jax_cache",
    "from_jax_params", "fused_attn_decode", "fused_linear_ar", "fused_mlp_ar",
    "grouped_matmul", "init_attention_state", "init_cache",
    "init_paged_cache", "init_seed", "kv_page_bytes", "launch_counts",
    "launch_forms", "matmul", "matmul_callable", "merge_decode_states",
    "paged_decode_attention", "paged_decode_attention_state", "perf_func",
    "reset_launch_counts", "resolve_device", "rms_norm", "rope_freqs",
    "sample_token", "tuned_matmul",
]
