"""MoE routing utilities: top-k routing, expert sorting, weighted combine
(counterpart of ``triton_distributed_tpu/ops/moe_utils.py``).

Convention, as in the JAX package: routing replicates each token k times
(one row per chosen expert); :func:`sort_by_expert` orders the replicated
rows by expert id; :func:`unsort_combine` inverts the sort and sums the k
copies with their routing weights.

Everything runs on the input's device and nothing is read back to the host:
the sorts are ``torch.argsort(stable=True)`` and the rows per expert are
counted with ``scatter_add_`` into zeros (``torch.bincount`` on CUDA reads
the largest id back to the host first).  The e4m3 aliases of
``lang/quant.py`` keep JAX's names (``moe_utils.py:31-42``).
``expert_block_permutation`` and ``global_presort_index`` belong to the TP
strategy at tp > 1 (ROADMAP A7).
"""

from __future__ import annotations

import torch

from ..lang import quant as _quant
from ..lang.quant import E4M3_MAX, SCALE_EPS  # noqa: F401 (JAX's names)


def quantize_e4m3(x: torch.Tensor, *, axis: int = -1):
    """Per-row e4m3 quantization: ``lang.quant.quantize_rows(x, "fp8")``."""
    return _quant.quantize_rows(x, "fp8", axis=axis)


def dequantize(x8: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_e4m3` (``lang.quant.dequantize_rows``)."""
    return _quant.dequantize_rows(x8, scale, dtype)


def topk_route(logits: torch.Tensor, k: int, *, renormalize: bool = True):
    """Softmax top-k routing.  ``logits``: (T, E) in any float type.
    Returns ``(expert_ids (T, k) int32, weights (T, k) f32)``: the softmax
    (in f32) probabilities of the chosen experts, largest first,
    renormalized to sum to 1 per token when ``renormalize``."""
    probs = torch.softmax(logits.float(), dim=-1)
    weights, expert_ids = torch.topk(probs, k, dim=-1)
    if renormalize:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    return expert_ids.to(torch.int32), weights


def flatten_topk(x: torch.Tensor, expert_ids: torch.Tensor,
                 weights: torch.Tensor):
    """(T, H) + (T, k) -> ``(x_rep (T*k, H), eid (T*k,), w (T*k,))``,
    row-major in (token, choice) order."""
    t, k = expert_ids.shape
    x_rep = x[:, None, :].expand(t, k, x.shape[-1]).reshape(t * k, -1)
    return x_rep, expert_ids.reshape(t * k), weights.reshape(t * k)


def sort_by_expert(x: torch.Tensor, expert_ids: torch.Tensor,
                   num_experts: int):
    """Stable-sort rows by expert id.  Returns ``(x_sorted, splits,
    unsort_idx)``: ``splits`` (num_experts,) int32 rows per expert,
    ``x_sorted[i] = x[sort_idx[i]]`` and ``x_sorted[unsort_idx] == x``."""
    sort_idx = torch.argsort(expert_ids, stable=True)
    x_sorted = torch.index_select(x, 0, sort_idx)
    splits = torch.zeros((num_experts,), dtype=torch.int32,
                         device=expert_ids.device)
    splits.scatter_add_(0, expert_ids.long(),
                        torch.ones_like(expert_ids, dtype=torch.int32))
    unsort_idx = torch.argsort(sort_idx, stable=True)
    return x_sorted, splits, unsort_idx


def unsort_combine(y_sorted: torch.Tensor, unsort_idx: torch.Tensor,
                   weights: torch.Tensor, k: int) -> torch.Tensor:
    """Invert :func:`sort_by_expert` and reduce the k routed copies with
    their weights (cast to y's dtype): (T*k, N) -> (T, N)."""
    y = torch.index_select(y_sorted, 0, unsort_idx)
    tk, n_dim = y.shape
    y = y.reshape(tk // k, k, n_dim)
    w = weights.reshape(tk // k, k, 1).to(y.dtype)
    return (y * w).sum(dim=1)

