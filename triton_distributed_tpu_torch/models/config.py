"""Model configuration (counterpart of
``triton_distributed_tpu/models/config.py``, field for field, with a torch
dtype)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Qwen3-family decoder hyperparameters (defaults: a tiny test model;
    Qwen3-8B values in the comments and in :data:`QWEN3_8B`)."""

    num_layers: int = 2            # 36
    hidden: int = 128              # 4096
    intermediate: int = 256        # 12288
    num_heads: int = 8             # 32
    num_kv_heads: int = 4          # 8
    head_dim: int = 64             # 128
    vocab: int = 512               # 151936
    max_length: int = 512          # 32k
    rope_theta: float = 1e6
    rms_eps: float = 1e-6
    qk_norm: bool = True           # Qwen3 normalizes Q/K per head
    dtype: torch.dtype = torch.bfloat16

    # MoE (Qwen3-MoE family): num_experts == 0 means dense layers
    num_experts: int = 0           # 128 (Qwen3-30B-A3B)
    top_k: int = 8
    moe_intermediate: int = 0      # 768; per-expert SwiGLU width
    norm_topk: bool = True         # renormalize routing weights over top-k
    moe_strategy: str = "tp"       # "tp" (served at tp = 1) | "ep" (experts partitioned)
    moe_fp8_wire: bool | str = False  # EP all-to-all e4m3 wire; "auto" off on co-located ranks

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0


QWEN3_8B = ModelConfig(
    num_layers=36, hidden=4096, intermediate=12288, num_heads=32,
    num_kv_heads=8, head_dim=128, vocab=151936, max_length=32768,
    rope_theta=1e6, rms_eps=1e-6, qk_norm=True, dtype=torch.bfloat16,
)
"""Qwen3-8B, from the public ``Qwen/Qwen3-8B`` ``config.json``:
hidden_size 4096, intermediate_size 12288, num_hidden_layers 36,
num_attention_heads 32, num_key_value_heads 8, head_dim 128, vocab_size
151936, rope_theta 1e6, rms_norm_eps 1e-6, bf16, tie_word_embeddings false
(untied lm_head), Q/K RMSNorm per head.  ``max_length`` is the serving cap of
the cache, not the model's 40960-position limit.  Nothing is downloaded: the
port builds random weights from a seed."""


QWEN3_30B_A3B = ModelConfig(
    num_layers=48, hidden=2048, intermediate=6144, num_heads=32,
    num_kv_heads=4, head_dim=128, vocab=151936, max_length=32768,
    rope_theta=1e6, rms_eps=1e-6, qk_norm=True, dtype=torch.bfloat16,
    num_experts=128, top_k=8, moe_intermediate=768, norm_topk=True,
)
"""Qwen3-30B-A3B, from the public ``Qwen/Qwen3-30B-A3B`` ``config.json``:
hidden_size 2048, intermediate_size 6144 (unused: ``mlp_only_layers`` is
empty and ``decoder_sparse_step`` 1, so every layer is MoE),
num_hidden_layers 48, num_attention_heads 32, num_key_value_heads 4,
head_dim 128, vocab_size 151936, num_experts 128, num_experts_per_tok 8,
moe_intermediate_size 768, norm_topk_prob true, rope_theta 1e6,
rms_norm_eps 1e-6, bf16, tie_word_embeddings false (untied lm_head), Q/K
RMSNorm per head.  ``max_length`` is the serving cap of the cache.  About
61.1 GB of bf16 weights (58.0 GB of them experts): it fits one 80 GB H100
whole.  Nothing is downloaded: the port builds random weights from a
seed."""
