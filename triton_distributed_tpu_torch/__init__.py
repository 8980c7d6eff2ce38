"""triton_distributed_tpu_torch: the PyTorch/CUDA port of the JAX package
``triton_distributed_tpu``, for NVIDIA Hopper GPUs.

The JAX package beside it stays the reference; this package imports neither
JAX nor any module of it.  It serves Qwen3 decoders, dense (Qwen3-8B) and
MoE (Qwen3-30B-A3B, TP strategy), on one NVIDIA Hopper GPU at tp = 1:
prefill, then decode on a contiguous or a paged KV cache, with
full-precision or int8 pages, in ``decode_mode`` "psum" (the per-kernel
chain) or "fused" (one attention megakernel per layer on a paged cache).
Attention and the MoE expert products run through hand-written CUDA kernels
(``csrc/``), built by ``nvcc`` for ``sm_90a`` at first use; every other
product is ``torch.matmul``.

Entry points run on CUDA unless the caller passes ``device="cpu"``, where
the kernels' plain PyTorch versions run instead.  Without CUDA and without
that request they raise.
"""

from .core.launches import launch_counts, launch_forms, reset_launch_counts
from .core.platform import card_identity, init_seed, resolve_device
from .core.utils import assert_allclose, cdiv, clip_block, perf_func
from .layers.moe import MoEMLP, MoEParams
from .layers.norm import rms_norm
from .models.config import QWEN3_8B, QWEN3_30B_A3B, ModelConfig
from .models.convert import from_jax_cache, from_jax_params
from .models.engine import Engine, sample_token
from .models.kv_cache import (
    KVCache,
    PagedKVCache,
    PagePoolExhausted,
    init_cache,
    init_paged_cache,
    kv_page_bytes,
)
from .models.qwen import Qwen3, QwenParams
from .ops.attention import (
    decode_attention,
    flash_attention,
    paged_decode_attention,
)
from .ops.fused_decode import fused_attn_decode, fused_linear_ar, fused_mlp_ar
from .ops.group_gemm import GroupGemmConfig, grouped_matmul
from .ops.rope import apply_rope, apply_rope_at, rope_freqs

__all__ = [
    "Engine", "GroupGemmConfig", "KVCache", "MoEMLP", "MoEParams",
    "ModelConfig", "PagePoolExhausted", "PagedKVCache", "QWEN3_30B_A3B",
    "QWEN3_8B", "Qwen3", "QwenParams", "apply_rope", "apply_rope_at",
    "assert_allclose", "card_identity", "cdiv", "clip_block",
    "decode_attention", "flash_attention", "from_jax_cache",
    "from_jax_params", "fused_attn_decode", "fused_linear_ar", "fused_mlp_ar",
    "grouped_matmul", "init_cache", "init_paged_cache", "init_seed",
    "kv_page_bytes", "launch_counts", "launch_forms",
    "paged_decode_attention", "perf_func", "reset_launch_counts",
    "resolve_device", "rms_norm", "rope_freqs", "sample_token",
]
