"""GEMM-AllReduce on a mesh of co-located ranks (K14).

Counterpart of ``triton_distributed_tpu/ops/gemm_ar.py``:
``AllReduce(A[:, K_r] @ B[K_r, :])`` on every rank, the row-parallel half
of a TP layer when every rank wants the whole activation (the decode
step's ``decode_mode="gemm_ar"``).  Two forms, chosen by K11's size rule on
the (M, N) partial's bytes (``ops/fused_decode.py::ar_method``, which is
``comm/allreduce.py::choose_method``), as the "ar" path chooses K11's:

- **one-shot** (decode sizes): the whole product in one pass over the
  weight, rounded once, then K11's one-shot exchange (the push into slot
  ``me`` of every rank, the slot-order f32 sum rounded once): one launch of
  K15's linear form (``csrc/fused_ar.cu``) writing every rank's copy;
  plain version :func:`ops.fused_decode.walk_oneshot`.
- **ring**: GEMM-RS's ring (``ops/gemm_rs.py``) whose last add lands in
  out-chunk ``me`` of the replicated output, then the AllGather ring of the
  reduced chunks (``comm/ring.py::ag_ring_phase``), with no barrier between
  them: the first writes only out-chunk ``me`` and every put of the second
  is gated by its own flag (JAX ``gemm_ar.py:93-138``).  One cooperative
  launch of ``csrc/overlap_gemm.cu``; plain version :func:`ring_program`
  walked on tensors.  Its adds are GEMM-RS's (the last one too: JAX adds in
  the output dtype, ``blocks.add_body``), so the result is bitwise that of
  the product followed by the two-shot AllReduce of K11, whose f32 fold of
  two values rounded once is the same add.

CPU tensors walk the chosen form's schedule (:func:`gemm_ar_ref`).

Port decisions: operands rank-stacked as GEMM-RS's; the result
``(*mesh.sizes, M, N)`` holds every rank's copy.  M must divide by n in
both forms (the ring cuts rows n ways; the model sends other batches to
the "ar" path, as JAX does, ``qwen.py:164-165``).  ``config``,
``wire_dtype``, tuple axes and n == 1 as in ``ops/gemm_rs.py``.
"""

from __future__ import annotations

import torch

from ..comm import ring
from ..comm.allreduce import AllReduceMethod
from ..comm.launch import check_config, check_tile_dims, gemm_operands, walk_teams
from ..core.launches import count
from ..core.mesh import TP_AXIS, Mesh
from ..lang import primitives as dl
from ..lang.primitives import Team
from .fused_decode import FORM_NAMES, _launch_ar, _out_bytes, ar_method, walk_oneshot
from .gemm_rs import launch_rs, make_chunk, rs_buffers
from .matmul import batched_product


def ring_program(team: Team, me: int) -> list:
    """The ring form: JAX ``_gemm_ar_kernel``'s schedule."""
    prog = []
    dl.collective_prologue(prog, team, me, neighbors_only=True)
    ring.rs_ring_phase(prog, team, me, ("out", me), last_f32=False, local="mm",
                       produce=make_chunk(prog))
    ring.ag_ring_phase(prog, team, me)
    ring.rs_ack_drain(prog, team.size)
    return prog


def _setup(a, b, mesh: Mesh, axis: str, out_dtype):
    out = torch.empty((*mesh.sizes, a.shape[-2], b.shape[-1]), dtype=out_dtype,
                      device=a.device)
    return Team.of(mesh, axis), a.contiguous(), b.contiguous(), out


def _method(a, b, mesh: Mesh, axis: str, out_dtype, method: AllReduceMethod) -> AllReduceMethod:
    return ar_method(_out_bytes(a.shape[-2], b.shape[-1], out_dtype), mesh.shape[axis], method)


def gemm_ar_ref(a: torch.Tensor, b: torch.Tensor, mesh: Mesh, axis: str = TP_AXIS, *,
                out_dtype=None,
                method: AllReduceMethod = AllReduceMethod.AUTO) -> torch.Tensor:
    """Plain version of K14, on any device: the schedule of ``method``'s
    form (AUTO: the kernel's choice) walked on tensors."""
    out_dtype = out_dtype or a.dtype
    method = _method(a, b, mesh, axis, out_dtype, method)
    team, a, b, out = _setup(a, b, mesh, axis, out_dtype)
    if not out.shape[-2]:
        return out
    if method == AllReduceMethod.ONE_SHOT:
        return walk_oneshot(False, a, None, b, mesh, axis, out_dtype)
    walk_teams(ring_program, team, rs_buffers(a, b, out, mesh, team.size, out_dtype))
    return out


def _gemm_ar(a: torch.Tensor, b: torch.Tensor, mesh: Mesh, axis: str, out_dtype,
             method: AllReduceMethod = AllReduceMethod.AUTO) -> torch.Tensor:
    """K14 in ``method``'s form (AUTO: by the size rule) for CUDA tensors,
    the plain version for CPU ones."""
    if not a.is_cuda:
        return gemm_ar_ref(a, b, mesh, axis, out_dtype=out_dtype, method=method)
    method = _method(a, b, mesh, axis, out_dtype, method)
    team, a, b, out = _setup(a, b, mesh, axis, out_dtype)
    if not out.shape[-2]:
        return out
    if method == AllReduceMethod.ONE_SHOT:
        out = _launch_ar(False, a, None, b, mesh, axis, out_dtype, method)
    else:
        launch_rs("tdt_gemm_ar", "gemm_ar", team, mesh, a, b, out, out_dtype)
    count("gemm_ar", (FORM_NAMES[method], team.size, tuple(a.shape[-2:]), tuple(b.shape[-2:])))
    return out


def gemm_ar(a: torch.Tensor, b: torch.Tensor, mesh: Mesh, axis: str = TP_AXIS, *,
            config=None, out_dtype=None,
            wire_dtype: str = "bf16") -> torch.Tensor:
    """Overlapped ``AllReduce(a @ b)`` over ``axis``.

    ``a``: rank-stacked ``(*mesh.sizes, M, k_loc)``; ``b``:
    ``(*mesh.sizes, k_loc, N)``.  Returns ``(*mesh.sizes, M, N)`` in
    ``out_dtype`` (a's by default): every rank's copy of the sum of the n
    partial products, in the one-shot or the ring form by the partial's
    bytes (see the module).  M must divide by n."""
    (m, k_loc), (_, cols), out_dtype = gemm_operands(a, b, mesh, axis, out_dtype, wire_dtype)
    check_config(config)
    n = mesh.shape[axis]
    if n == 1:
        return batched_product(a, b, out_dtype)
    if m % n:
        raise ValueError(f"M = {m} not divisible by {axis}={n}: the ring cuts rows n ways")
    check_tile_dims(k_loc, cols)
    return _gemm_ar(a, b, mesh, axis, out_dtype)
