"""Carry weights and KV caches across from the JAX package.

The input is a JAX tree (``QwenParams``, ``KVCache`` or ``PagedKVCache``)
after ``jax.tree.map(np.asarray, ...)``, read duck-typed (``.embed``,
``.layers[i].ln1``, ``.attn.wqkv``, ``.block_table``, ...): nothing of the
JAX package is imported.  At tp = 1 both packages store ``wqkv`` as
``[q | k | v]``, ``gate_up`` as ``[gate | up]`` and the caches in the same
layouts, so the tensors carry over unchanged.  MoE layers carry their
router and expert weights across the same way: at tp = 1 the JAX ``w_up``
is plain per-expert ``[gate | up]``, and so it is under EP at any tp
(``fuse_expert_gate_up(ep=True)``); JAX's ``P(axis, None, None)`` expert
shards, gathered by ``np.asarray``, are the port's (E, ...) tensors as they
are (rank r's experts their rows ``[r E/n, (r + 1) E/n)``).

With ``mesh`` (tp = n co-located ranks) the JAX tree must have been built at
tp = n: its ``wqkv`` and ``gate_up`` columns rank-blocked n ways, which the
port stacks rank by rank, and its caches head-sharded n ways, which the port
keeps rank-folded (``models/kv_cache.py``).  :func:`reblock` carries fused
columns between tp sizes, for weights built at another tp.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.mesh import TP_AXIS, Mesh
from ..core.platform import resolve_device
from ..layers.moe import MoEParams
from ..layers.tp_attn import TPAttnParams
from ..layers.tp_mlp import TPMLPParams, reblock, stack_columns, stack_rows
from .config import ModelConfig
from .kv_cache import KVCache, PagedKVCache, fold_heads, fold_table

__all__ = ["from_jax_cache", "from_jax_params", "reblock", "to_tensor"]
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


def _tp(mesh: Mesh | None, axis: str) -> int:
    return 1 if mesh is None else mesh.shape[axis]


def from_jax_params(params, config: ModelConfig, device=None, *,
                    mesh: Mesh | None = None, axis: str = TP_AXIS) -> QwenParams:
    """The port's :class:`QwenParams` holding the same weights as the JAX
    tree ``params`` (dense or MoE layers, as ``config`` says).  With
    ``mesh``, the tree was built at that mesh's tp = n, and the projections
    become rank-stacked shards on the mesh's device; the replicated weights
    stay one copy."""
    n = _tp(mesh, axis)
    dev = mesh.device if mesh is not None else resolve_device(device)
    if len(params.layers) != config.num_layers:
        raise ValueError(f"{len(params.layers)} layers in params, config has "
                         f"{config.num_layers}")
    if n > 1 and config.is_moe and config.moe_strategy != "ep":
        raise NotImplementedError("MoE under moe_strategy 'tp' at tp > 1 is not ported yet "
                                  "(ROADMAP A7); moe_strategy 'ep' is")

    def t(a):
        return to_tensor(a, dev)

    def cols(a):   # rank-blocked columns -> (n, K, C / n)
        return stack_columns(t(a), n) if n > 1 else t(a)

    def rows(a):   # row shards -> (n, R / n, K)
        return stack_rows(t(a), n) if n > 1 else t(a)

    layers = [
        QwenLayerParams(
            ln1=t(lp.ln1),
            attn=TPAttnParams(wqkv=cols(lp.attn.wqkv), wo=rows(lp.attn.wo),
                              q_norm=t(lp.attn.q_norm), k_norm=t(lp.attn.k_norm)),
            ln2=t(lp.ln2),
            mlp=(MoEParams(router=t(lp.mlp.router), w_up=t(lp.mlp.w_up),
                           w_dn=t(lp.mlp.w_dn)) if config.is_moe
                 else TPMLPParams(gate_up=cols(lp.mlp.gate_up),
                                  down=rows(lp.mlp.down))),
        )
        for lp in params.layers
    ]
    return QwenParams(embed=t(params.embed), layers=layers,
                      final_norm=t(params.final_norm), lm_head=t(params.lm_head))


def from_jax_cache(cache, device=None, *, mesh: Mesh | None = None,
                   axis: str = TP_AXIS) -> KVCache | PagedKVCache:
    """The port's cache holding the same state as the JAX ``cache``: a
    contiguous ``KVCache`` (its ``kv_len`` a 0-d int32 tensor on ``device``) or a
    ``PagedKVCache``, int8 pools and their scales included.  With ``mesh``
    (tp = n), the JAX cache's heads are cut n ways and rank-folded
    (``models/kv_cache.py``)."""
    n = _tp(mesh, axis)
    dev = mesh.device if mesh is not None else resolve_device(device)
    if n > 1:
        k, v = (fold_heads(to_tensor(a, dev), n) for a in (cache.k, cache.v))
        if not hasattr(cache, "block_table"):
            return KVCache(k=k, v=v, kv_len=to_tensor(cache.kv_len, dev))
        if getattr(cache, "k_scale", None) is not None:
            raise NotImplementedError("int8 pages at tp > 1 are not ported yet")
        table = to_tensor(cache.block_table, dev).to(torch.int32)
        lens = to_tensor(cache.seq_lens, dev).to(torch.int32)
        return PagedKVCache(k=k, v=v, block_table=fold_table(table, n, k.shape[1] // n),
                            seq_lens=lens.repeat(n))
    if hasattr(cache, "block_table"):
        return PagedKVCache(
            k=to_tensor(cache.k, dev), v=to_tensor(cache.v, dev),
            block_table=to_tensor(cache.block_table, dev).to(torch.int32),
            seq_lens=to_tensor(cache.seq_lens, dev).to(torch.int32),
            k_scale=to_tensor(getattr(cache, "k_scale", None), dev),
            v_scale=to_tensor(getattr(cache, "v_scale", None), dev))
    return KVCache(k=to_tensor(cache.k, dev), v=to_tensor(cache.v, dev),
                   kv_len=to_tensor(cache.kv_len, dev))
