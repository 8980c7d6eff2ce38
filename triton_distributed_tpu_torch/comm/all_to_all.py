"""EP (expert-parallel) all-to-all: the MoE token dispatch and combine on a
mesh of co-located ranks (K17).

Counterpart of ``triton_distributed_tpu/comm/all_to_all.py``.  E experts,
``epr = E / n`` a rank; rank r owns experts ``[r epr, (r + 1) epr)``.  Tensors
are rank-stacked (``core/mesh.py``):

- dispatch in: ``x`` ``(*mesh.sizes, T, H)``, each rank's rows sorted by
  expert (T the static worst case; rows past the real count are padding),
  and ``splits`` ``(*mesh.sizes, E)`` int32, each rank's rows per expert;
- dispatch out: ``recv`` ``(*mesh.sizes, n, Z, H)``, each rank's n landing
  zones by source rank (``Z = round_up(T, chunk) + chunk``, as JAX's), and
  ``recv_splits`` ``(*mesh.sizes, n, epr)``, per source the counts of each
  owned expert;
- combine in: ``y`` in the zone layout of dispatch, the same ``splits`` and
  ``token_dim`` = T; combine out: ``(*mesh.sizes, T, H)`` in each rank's
  original sorted order.

The per-peer counts (the metadata JAX moves with ``lax.all_to_all``) are a
transpose of device tensors here, as JAX leaves them to XLA; the rows move
in one cooperative launch of K17 (``csrc/all_to_all.cu``) over every rank,
which reads the counts and offsets on the device.  Nothing reads a count
back to the host on the card.  The rank-level schedule is
``comm/ring.py::a2a_push_phase``; the plain versions walk it on tensors
(CPU tensors take them).  On the card the rows of each destination are
shared among as many lanes as the card holds, with one credit and one wait
per (lane, source) at device scope, in place of JAX's credit per
``chunk``-row put (``comm/lanes.py`` walks that protocol).  Combine is the
same push with the roles swapped, then the exact repack, a gather whose
indices are computed on the device.

Port decisions:

- Zone rows past a zone's count have no defined value on the card (the
  kernel copies exact rows; JAX's chunk-rounded DMAs dragged neighbours in,
  which ``xla_ep_dispatch`` zeroes).  The plain version zeroes them.  A
  combine row past a rank's real total is gathered from such a tail, as in
  JAX, and is undefined too.
- ``recv`` (dispatch) lands in one grow-only buffer per (team, stream,
  dtype) (``core/symm.py::landing``): it is valid until the next dispatch of
  that dtype on that stream.  Combine's zones land in a buffer of their
  own; its repacked output is a fresh tensor.
- ``config=None`` is ``AllToAllConfig()``: JAX's tuner sweep of the chunk
  (``_resolve_a2a_config``) waits for ROADMAP A5, and so does
  ``wire_dtype="auto"``.  "int8" and "fp8" pack each row with K18
  (``lang/quant.py``), move the u8 message and unpack it on arrival
  (forward only; the straight-through backward comes with training).
- A tuple (hierarchical) axis raises: it needs more than one card.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..core import build, symm
from ..core.launches import count
from ..core.mesh import EP_AXIS, Mesh
from ..core.utils import cdiv
from ..lang import quant
from ..lang.primitives import Team
from . import ring
from .launch import stacked_shard


@dataclasses.dataclass(frozen=True)
class AllToAllConfig:
    """``chunk``: rows a put of the rank-level schedule (each credited on its
    own there; K17 credits once per lane and destination) and the zones'
    rounding (:func:`zone_geometry`); ``schedule``: the peer offsets in
    emission order (a permutation of range(n)), None for 0..n-1."""

    chunk: int = 128
    schedule: tuple[int, ...] | None = None


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def zone_geometry(t: int, config: AllToAllConfig) -> tuple[int, int]:
    """(rows a put, rows a zone) for T rows a rank, as JAX sizes them: a
    zone holds every row of one source plus a chunk."""
    chunk = min(config.chunk, _round_up(max(t, 1), 8))
    return chunk, _round_up(t, chunk) + chunk


_PEERS: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}


def _peer_index(team: Team, mesh: Mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """(peer slot (S, n), own rank (S, 1)) as device int64, made once per
    (team, device): slot s's team member p is at mesh slot peer[s, p]."""
    key = (team, str(mesh.device))
    if key not in _PEERS:
        slots = range(mesh.size)
        _PEERS[key] = (
            torch.tensor([[team.device_id(p, s) for p in range(team.size)] for s in slots],
                         device=mesh.device),
            torch.tensor([[team.rank(s)] for s in slots], device=mesh.device))
    return _PEERS[key]


@dataclasses.dataclass
class _Meta:
    """Device int32 counts of one exchange, (S, n) per mesh slot: rows sent
    to each team peer, their first row, rows each peer sends; and
    ``recv_splits`` (S, n, epr)."""

    send: torch.Tensor
    offs: torch.Tensor
    expected: torch.Tensor
    recv_splits: torch.Tensor


def _meta(splits: torch.Tensor, team: Team, mesh: Mesh) -> _Meta:
    n = team.size
    spl = splits.reshape(mesh.size, n, -1).to(torch.int32)
    send = spl.sum(-1, dtype=torch.int32)
    offs = torch.cumsum(send, 1, dtype=torch.int32) - send
    peer, rank = _peer_index(team, mesh)
    return _Meta(send, offs, send[peer, rank], spl[peer, rank])


def _check_splits(splits: torch.Tensor, mesh: Mesh, n: int) -> int:
    if tuple(splits.shape[:-1]) != mesh.sizes or splits.dim() != len(mesh.axes) + 1:
        raise ValueError(f"splits {tuple(splits.shape)} must be rank-stacked (*{mesh.sizes}, E)")
    if splits.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"splits must be int32 or int64, not {splits.dtype}")
    if splits.device != mesh.device:
        raise ValueError(f"splits is on {splits.device}, the mesh on {mesh.device}")
    e = splits.shape[-1]
    if e % n:
        raise ValueError(f"E = {e} experts do not divide among {n} ranks")
    return e // n


def _check_wire(wire_dtype: str) -> None:
    if wire_dtype == "auto":
        raise NotImplementedError(
            "wire_dtype='auto' resolves through the contextual tuner (ROADMAP A5), not ported "
            "yet; pass 'bf16', 'int8' or 'fp8'")
    quant.is_quantized(wire_dtype)   # raises on a wire dtype not in quant.WIRE_DTYPES


def _push_ref(x, out, send, offs, expected, team: Team, mesh: Mesh, chunk: int, order) -> None:
    """The plain version of K17: every team's push programs walked on views
    of ``x`` (S, rows, H) and ``out`` (S, n, Z, H); it reads the counts on
    the host."""
    n = team.size
    send, offs, expected = (t.reshape(mesh.size, n).tolist() for t in (send, offs, expected))
    for group in team.groups():
        programs, bufs = [], []
        for r, s in enumerate(group):
            programs.append([])
            ring.a2a_push_phase(programs[-1], team, r, send[s], expected[s], chunk, order)
            xb = {(dst, c): x[s, offs[s][dst] + c * chunk:
                                min(offs[s][dst] + send[s][dst], offs[s][dst] + (c + 1) * chunk)]
                  for dst in range(n) for c in range(cdiv(send[s][dst], chunk))}
            zb = {(src, c): out[s, src, c * chunk:min(expected[s][src], (c + 1) * chunk)]
                  for src in range(n) for c in range(cdiv(expected[s][src], chunk))}
            bufs.append({"x": xb, "zones": zb})
        ring.walk(programs, bufs)


def _push(role: str, x, out, send, offs, expected, team: Team, mesh: Mesh, chunk: int,
          z: int, config: AllToAllConfig, plain: bool, stall_rank: int,
          system_scope: bool = False) -> None:
    """Rows of ``x`` (S, rows, H) into the zones ``out`` (S, n, Z, H): the
    plain version when ``plain`` or on CPU tensors, else K17 (one
    cooperative launch, counted under ``role``).  ``stall_rank`` >= 0 (tests
    of the bounded waits only) makes that rank credit none of its puts;
    ``system_scope`` launches K17's system-scope form (with the entry
    barrier), kept for the multi-card host (ROADMAP A11)."""
    order = config.schedule
    if order is not None and sorted(order) != list(range(team.size)):
        raise ValueError(f"schedule {order} is not a permutation of range({team.size})")
    if plain or not x.is_cuda:
        _push_ref(x, out, send, offs, expected, team, mesh, chunk, order)
        return
    row_bytes = x.shape[-1] * x.element_size()
    if row_bytes % 16:
        raise ValueError(f"rows of {row_bytes} bytes: K17 moves rows of a multiple of 16 bytes")
    coll = symm.coll_args(team, mesh, x=x.reshape(*mesh.sizes, *x.shape[1:]),
                          out=out.reshape(*mesh.sizes, *out.shape[1:]), land=None,
                          pad=symm.signal_pad(mesh, team.axis, "all_to_all"), chunk_elems=0,
                          method=0, stall_rank=stall_rank, system_scope=system_scope)
    args = symm.A2aArgs(coll, send.data_ptr(), offs.data_ptr(), row_bytes, z)
    for i, p in enumerate(order if order is not None else range(team.size)):
        args.order[i] = p
    build.check(build.library().tdt_all_to_all(
        ctypes.byref(args), torch.cuda.current_stream(x.device).cuda_stream), "all_to_all")
    count("all_to_all", (role, team.size, x.shape[1], row_bytes))


def _dispatch(x, splits, mesh: Mesh, axis: str, config: AllToAllConfig, *,
              plain: bool = False, stall_rank: int = -1, system_scope: bool = False):
    t, h = stacked_shard(x, mesh, axis)
    team = Team.of(mesh, axis)
    _check_splits(splits, mesh, team.size)
    meta = _meta(splits, team, mesh)
    chunk, z = zone_geometry(t, config)
    if x.is_cuda and not plain:
        recv = symm.landing(mesh, axis, "ep_dispatch", (team.size, z, h), x.dtype).data
    else:
        recv = torch.zeros((*mesh.sizes, team.size, z, h), dtype=x.dtype, device=x.device)
    _push("dispatch", x.contiguous().reshape(mesh.size, t, h),
          recv.reshape(mesh.size, team.size, z, h), meta.send, meta.offs, meta.expected, team,
          mesh, chunk, z, config, plain, stall_rank, system_scope)
    return recv, meta.recv_splits.reshape(*mesh.sizes, team.size, -1)


def ep_dispatch(x: torch.Tensor, splits: torch.Tensor, mesh: Mesh, axis: str = EP_AXIS, *,
                config: AllToAllConfig | None = None, wire_dtype: str = "bf16"):
    """Send each rank's expert-sorted rows to the ranks that own their
    experts (module docstring for the layouts).  Returns ``(recv,
    recv_splits)``; on the card ``recv`` is the dispatch landing buffer,
    valid until the next dispatch of its dtype.  ``n == 1`` returns ``x``
    as the one zone and all of ``splits`` (JAX's shortcut).  "int8" and
    "fp8" ship the packed message (:mod:`comm.quantized`)."""
    _check_wire(wire_dtype)
    stacked_shard(x, mesh, axis)
    if mesh.shape[axis] == 1:
        _check_splits(splits, mesh, 1)
        return x.unsqueeze(-3), splits.to(torch.int32).unsqueeze(-2)
    if wire_dtype != "bf16":
        from .quantized import quantized_ep_dispatch

        return quantized_ep_dispatch(mesh, axis, config, x.shape[-1], wire_dtype, x, splits)
    return _dispatch(x, splits, mesh, axis, config or AllToAllConfig())


def ep_dispatch_ref(x, splits, mesh: Mesh, axis: str = EP_AXIS, *,
                    config: AllToAllConfig | None = None):
    """Plain version of :func:`ep_dispatch` (bf16 wire), on any device: the
    schedule walked on tensors; zone tails are zero."""
    return _dispatch(x, splits, mesh, axis, config or AllToAllConfig(), plain=True)


def _repack_index(meta: _Meta, mesh: Mesh, n: int, z: int, t: int) -> torch.Tensor:
    """Flat row of each rank's sorted row i in the (S n Z) returned zones
    (JAX ``_build_combine``): row i came back in zone p (its destination,
    the first whose running count passes i; clipped to n - 1) at i - offs[p]."""
    i = torch.arange(t, dtype=torch.int32, device=meta.send.device).expand(mesh.size, t)
    cum = torch.cumsum(meta.send, 1, dtype=torch.int32)
    p = torch.searchsorted(cum, i.contiguous(), right=True).clamp_(max=n - 1)
    within = i - torch.gather(meta.offs, 1, p)
    slot = torch.arange(mesh.size, device=p.device)[:, None]
    return ((slot * n + p) * z + within).reshape(-1)


def _combine(y, splits, mesh: Mesh, axis: str, token_dim: int, config: AllToAllConfig, *,
             plain: bool = False, system_scope: bool = False):
    team = Team.of(mesh, axis)
    n = team.size
    shard = stacked_shard(y, mesh, axis)
    if len(shard) != 3 or shard[0] != n:
        raise ValueError(f"y {tuple(y.shape)} must be rank-stacked zones (*{mesh.sizes}, {n}, "
                         f"Z, H)")
    _, z, h = shard
    _check_splits(splits, mesh, n)
    meta = _meta(splits, team, mesh)
    chunk, _ = zone_geometry(token_dim, config)
    if chunk > z:
        raise ValueError(f"zones of {z} rows are smaller than a put of {chunk}")
    if y.is_cuda and not plain:
        back = symm.landing(mesh, axis, "ep_combine", (n, z, h), y.dtype).data
    else:
        back = torch.zeros((*mesh.sizes, n, z, h), dtype=y.dtype, device=y.device)
    zone_offs = (torch.arange(n, dtype=torch.int32, device=y.device) * z).expand(mesh.size, n)
    # roles swapped: zone p's rows go back to p, p's count of mine comes back
    _push("combine", y.contiguous().reshape(mesh.size, n * z, h),
          back.reshape(mesh.size, n, z, h), meta.expected, zone_offs.contiguous(), meta.send,
          team, mesh, chunk, z, config, plain, -1, system_scope)
    out = back.reshape(-1, h).index_select(0, _repack_index(meta, mesh, n, z, token_dim))
    return out.reshape(*mesh.sizes, token_dim, h)


def ep_combine(y: torch.Tensor, splits: torch.Tensor, mesh: Mesh, axis: str = EP_AXIS, *,
               token_dim: int, config: AllToAllConfig | None = None,
               wire_dtype: str = "bf16") -> torch.Tensor:
    """Return the processed zone rows to their source ranks and restore each
    rank's sorted order: ``y`` (*mesh.sizes, n, Z, H), the ``splits`` given
    to dispatch, ``token_dim`` = T; returns (*mesh.sizes, T, H), a fresh
    tensor.  ``n == 1`` takes the first T rows of the one zone."""
    _check_wire(wire_dtype)
    stacked_shard(y, mesh, axis)
    if mesh.shape[axis] == 1:
        return y.reshape(*mesh.sizes, -1, y.shape[-1])[..., :token_dim, :]
    if wire_dtype != "bf16":
        from .quantized import quantized_ep_combine

        return quantized_ep_combine(mesh, axis, config, y.shape[-1], wire_dtype, token_dim, y,
                                    splits)
    return _combine(y, splits, mesh, axis, token_dim, config or AllToAllConfig())


def ep_combine_ref(y, splits, mesh: Mesh, axis: str = EP_AXIS, *, token_dim: int,
                   config: AllToAllConfig | None = None) -> torch.Tensor:
    """Plain version of :func:`ep_combine` (bf16 wire), on any device."""
    return _combine(y, splits, mesh, axis, token_dim, config or AllToAllConfig(), plain=True)
