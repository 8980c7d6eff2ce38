"""Carry weights and KV caches across from the JAX package.

The input is a JAX tree (``QwenParams``, ``KVCache`` or ``PagedKVCache``)
after ``jax.tree.map(np.asarray, ...)``, read duck-typed (``.embed``,
``.layers[i].ln1``, ``.attn.wqkv``, ``.block_table``, ...): nothing of the
JAX package is imported.  At tp = 1 both packages store ``wqkv`` as
``[q | k | v]``, ``gate_up`` as ``[gate | up]`` and the caches in the same
layouts, so the tensors carry over unchanged.  MoE layers carry their
router and expert weights across the same way: at tp = 1 the JAX ``w_up``
is plain per-expert ``[gate | up]``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.platform import resolve_device
from ..layers.moe import MoEParams
from ..layers.tp_attn import TPAttnParams
from ..layers.tp_mlp import TPMLPParams
from .config import ModelConfig
from .kv_cache import KVCache, PagedKVCache
from .qwen import QwenLayerParams, QwenParams


def to_tensor(a, device) -> torch.Tensor | None:
    """A numpy array (bfloat16 included, which numpy stores as ml_dtypes'
    2-byte type) as a tensor on ``device``; None stays None."""
    if a is None:
        return None
    a = np.array(a)  # a writable copy: device_get arrays are read-only
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def from_jax_params(params, config: ModelConfig, device=None) -> QwenParams:
    """The port's :class:`QwenParams` holding the same weights as the JAX
    tree ``params`` (dense or MoE layers, as ``config`` says)."""
    dev = resolve_device(device)
    if len(params.layers) != config.num_layers:
        raise ValueError(f"{len(params.layers)} layers in params, config has "
                         f"{config.num_layers}")

    def t(a):
        return to_tensor(a, dev)

    layers = [
        QwenLayerParams(
            ln1=t(lp.ln1),
            attn=TPAttnParams(wqkv=t(lp.attn.wqkv), wo=t(lp.attn.wo),
                              q_norm=t(lp.attn.q_norm), k_norm=t(lp.attn.k_norm)),
            ln2=t(lp.ln2),
            mlp=(MoEParams(router=t(lp.mlp.router), w_up=t(lp.mlp.w_up),
                           w_dn=t(lp.mlp.w_dn)) if config.is_moe
                 else TPMLPParams(gate_up=t(lp.mlp.gate_up),
                                  down=t(lp.mlp.down))),
        )
        for lp in params.layers
    ]
    return QwenParams(embed=t(params.embed), layers=layers,
                      final_norm=t(params.final_norm), lm_head=t(params.lm_head))


def from_jax_cache(cache, device=None) -> KVCache | PagedKVCache:
    """The port's cache holding the same state as the JAX ``cache``: a
    contiguous ``KVCache`` (its ``kv_len`` becomes a host int) or a
    ``PagedKVCache``, int8 pools and their scales included."""
    dev = resolve_device(device)
    if hasattr(cache, "block_table"):
        return PagedKVCache(
            k=to_tensor(cache.k, dev), v=to_tensor(cache.v, dev),
            block_table=to_tensor(cache.block_table, dev).to(torch.int32),
            seq_lens=to_tensor(cache.seq_lens, dev).to(torch.int32),
            k_scale=to_tensor(getattr(cache, "k_scale", None), dev),
            v_scale=to_tensor(getattr(cache, "v_scale", None), dev))
    return KVCache(k=to_tensor(cache.k, dev), v=to_tensor(cache.v, dev),
                   kv_len=int(np.asarray(cache.kv_len)))
