"""Symmetric buffers and signal pads of co-located ranks, and the launch
arguments that carry their peer tables.

Counterpart of ``triton_distributed_tpu/core/symm.py``.  A symmetric buffer
gives every rank of a mesh the same local shape; any rank can address any
peer's copy.  Here one device allocation holds all ranks' copies in the
rank-stacked layout (``core/mesh.py``), and a kernel is handed one base
address per mesh slot: the peer table, a struct of at most eight pointers
passed by value in the launch (:class:`CollArgs`), so a call copies nothing
to the device and does not synchronize.

Signal pads hold the flags of ``csrc/dl.cuh``: one row of
``FLAGS_PER_LANE`` int32 per lane (block index) of a launch, per rank; K12
and K13 keep their lanes in the first half of the rows, and K13 its
(hop, tile) flags in the second (``comm/tiles.py``).  A pad
persists per (team, family) and is zero at rest: every collective takes
every credit it is given before it ends, so the host never clears a pad
between calls.  Landing slots (the ReduceScatter ring's receive slots, the
one-shot AllReduce's per-source slots, the GEMM-RS and GEMM-AR chunk
products) are views of one grow-only buffer per (team, family, dtype), as
large as the largest call so far, so a server's varying row counts hold no
more than that; outputs are fresh tensors per call.  A buffer may not grow
while a CUDA graph is being captured (a graph captured earlier would address
the freed one); a captured step keeps every pad and buffer alive
(:func:`live_buffers`, ``tools/aot.py``).  Pads and slots are kept per CUDA stream as well, so collectives on
two streams never share them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from ..lang.primitives import FLAGS_PER_LANE, Team, flag_name
from .mesh import MAX_RANKS, Mesh

# lanes a launch may use: the pads' rows (at least the blocks an H100 holds
# at once, 132 SMs x 8 blocks of 256 threads)
MAX_LANES = 2048
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass
class SymmetricBuffer:
    """Every rank's ``local_shape`` copy, stacked: ``data`` is
    ``(*mesh.sizes, *local_shape)``, one allocation."""

    data: torch.Tensor
    mesh: Mesh
    axis: str
    local_shape: tuple[int, ...]

    def ptrs(self) -> list[int]:
        return slot_ptrs(self.data, self.mesh)


def slot_ptrs(t: torch.Tensor, mesh: Mesh) -> list[int]:
    """Base address of each mesh slot's part of a rank-stacked tensor: the
    peer table of ``t``.  Each part must be contiguous; the parts may lie at
    a larger stride (landing slots are views of a larger buffer)."""
    slots = t.view(mesh.size, *t.shape[len(mesh.axes):])
    if not slots[0].is_contiguous():
        raise ValueError("each rank's part of a rank-stacked tensor handed to a kernel "
                         "must be contiguous")
    return [slots[s].data_ptr() for s in range(mesh.size)]


def symm_buffer(mesh: Mesh, axis: str, local_shape, dtype=torch.bfloat16) -> SymmetricBuffer:
    """A zeroed workspace of ``local_shape`` on every rank (reference
    ``nvshmem_create_tensor``)."""
    local_shape = tuple(int(d) for d in local_shape)
    data = torch.zeros((*mesh.sizes, *local_shape), dtype=dtype, device=mesh.device)
    return SymmetricBuffer(data, mesh, axis, local_shape)


def symm_signal(mesh: Mesh, axis: str, n_flags: int = 1) -> SymmetricBuffer:
    """Persistent int32 counting flags, ``n_flags`` per rank, zero."""
    return symm_buffer(mesh, axis, (n_flags,), torch.int32)


_pads: dict[tuple, SymmetricBuffer] = {}
_landing: dict[tuple, torch.Tensor] = {}


def _team_key(mesh: Mesh, axis: str) -> tuple:
    """(team, device, stream): launches on one stream run in order, so they
    may share flags and slots; launches on two streams may overlap, so they
    never do."""
    cuda = mesh.device.type == "cuda"
    stream = torch.cuda.current_stream(mesh.device).cuda_stream if cuda else 0
    return (Team.of(mesh, axis), str(mesh.device), stream)


def signal_pad(mesh: Mesh, axis: str, family: str) -> SymmetricBuffer:
    """The (team, family)'s pad: ``MAX_LANES x FLAGS_PER_LANE`` flags per rank,
    made zero once and kept."""
    key = (*_team_key(mesh, axis), family)
    if key not in _pads:
        _pads[key] = symm_signal(mesh, axis, MAX_LANES * FLAGS_PER_LANE)
    return _pads[key]


def landing(mesh: Mesh, axis: str, family: str, local_shape, dtype) -> SymmetricBuffer:
    """Landing slots of ``local_shape`` on every rank: a view of the
    (team, family, dtype)'s buffer, which grows to the largest call so far and
    never shrinks.  They need no clearing: every slot is written before it
    is read.  A grown buffer frees the old one in stream order, so a launch
    still queued on the stream keeps its memory until it is done."""
    local_shape = tuple(int(d) for d in local_shape)
    need = math.prod(local_shape)
    key = (*_team_key(mesh, axis), family, dtype)
    if key not in _landing or _landing[key].shape[1] < need:
        if mesh.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            # a graph captured before would address the buffer this frees
            raise RuntimeError(
                f"landing buffer {family} grows to {need} elements during a CUDA graph "
                "capture: run the step on the capture stream first (tools/aot.py)")
        _landing[key] = torch.empty((mesh.size, need), dtype=dtype, device=mesh.device)
    data = _landing[key][:, :need].unflatten(1, local_shape).unflatten(0, mesh.sizes)
    return SymmetricBuffer(data, mesh, axis, local_shape)


def live_buffers() -> list[torch.Tensor]:
    """Every pad and landing buffer made so far: what a CUDA graph holds on
    to, so that a buffer its launches address outlives a later growth."""
    return [p.data for p in _pads.values()] + list(_landing.values())


def signal_pads() -> dict[tuple, SymmetricBuffer]:
    """Every pad made so far, by (team, device, stream, family): a check that they
    all read zero after a call is a check of the protocol's drains."""
    return dict(_pads)


# ---------------------------------------------------------------------------
# launch arguments (csrc/dl.cuh CollArgs, field for field)


class _Peers(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p * MAX_RANKS)]


class CollArgs(ctypes.Structure):
    """The launch's arguments, copied by value into the kernel's parameters."""

    _fields_ = [
        ("x", _Peers), ("out", _Peers), ("land", _Peers), ("flags", _Peers),
        ("record", ctypes.c_void_p),
        ("chunk_elems", ctypes.c_longlong),
        ("n", ctypes.c_int), ("groups", ctypes.c_int),
        ("slot", ctypes.c_int * MAX_RANKS),
        ("method", ctypes.c_int), ("dtype", ctypes.c_int),
        ("out_dtype", ctypes.c_int), ("elsize", ctypes.c_int),
        ("stall_rank", ctypes.c_int), ("scope", ctypes.c_int),
    ]


class A2aArgs(ctypes.Structure):
    """The EP all-to-all's launch arguments (csrc/all_to_all.cu A2aArgs):
    the :class:`CollArgs` (x the source rows, out the landing zones), the
    device int32 (mesh slots, n) counts and offsets, the row's bytes, the
    rows a zone, and the peer offsets in emission order."""

    _fields_ = [("c", CollArgs), ("counts", ctypes.c_void_p), ("offs", ctypes.c_void_p),
                ("row_bytes", ctypes.c_longlong), ("z", ctypes.c_int),
                ("order", ctypes.c_int * MAX_RANKS)]


class GemmArgs(ctypes.Structure):
    """The overlapped GEMMs' launch arguments (csrc/overlap_gemm.cu
    GemmArgs): the ring's :class:`CollArgs`, the peer tables of the A and B
    operands and of the GEMM's output ``y``, and one chunk's product shape
    (m_loc, k) @ (k, n_cols)."""

    _fields_ = [("c", CollArgs), ("a", _Peers), ("b", _Peers), ("y", _Peers),
                ("m_loc", ctypes.c_int), ("k", ctypes.c_int), ("n_cols", ctypes.c_int)]


class Gemv(ctypes.Structure):
    """A decode product's plan (csrc/fused_ar.cuh Gemv): B rows, depth Kd,
    ``cols`` output columns, the K rows cut into ``n_kslice`` slices of
    ``k_chunk``."""

    _fields_ = [("B", ctypes.c_int), ("Kd", ctypes.c_int), ("cols", ctypes.c_int),
                ("n_kslice", ctypes.c_int), ("k_chunk", ctypes.c_int)]


class FusedArArgs(ctypes.Structure):
    """K15's launch arguments (csrc/fused_ar.cu FusedArArgs): the ring's
    :class:`CollArgs`, the peer tables of the activations, the gate/up and
    down (or o-proj) weights, the SwiGLU output and the f32 partials, the
    (B, N) result, and the products' plans."""

    _fields_ = [("c", CollArgs), ("a", _Peers), ("w_up", _Peers), ("w", _Peers),
                ("act", _Peers), ("part", _Peers), ("rows_out", ctypes.c_void_p),
                ("K", ctypes.c_int), ("F", ctypes.c_int), ("N", ctypes.c_int),
                ("up", Gemv), ("dn", Gemv)]


PERSISTENT_REGIONS = ("x", "h", "att", "act", "q_buf", "k_tok", "v_tok", "part_proj",
                      "part_acc", "part_ml", "part")


class PersistentArgs(ctypes.Structure):
    """K16's launch arguments (csrc/persistent_decode.cu PersistentArgs):
    the ring's :class:`CollArgs`, the layer table and each weight kind's
    per-rank stride, the step's tensors, each rank's scratch base and the
    regions' offsets in it (:data:`PERSISTENT_REGIONS`), and the plans."""

    _fields_ = [("c", CollArgs), ("layers", ctypes.c_void_p),
                ("w_stride", ctypes.c_longlong * 8),
                ("x_in", ctypes.c_void_p), ("x_out", ctypes.c_void_p),
                ("pool_k", ctypes.c_void_p), ("pool_v", ctypes.c_void_p),
                ("table", ctypes.c_void_p), ("lens", ctypes.c_void_p),
                ("inv_freq", ctypes.c_void_p), ("scratch", _Peers),
                ("off", ctypes.c_longlong * len(PERSISTENT_REGIONS)),
                ("layer_pool_elems", ctypes.c_longlong),
                *[(f, ctypes.c_int) for f in ("L", "B", "K", "F", "hk", "ps", "mp", "proj_nks",
                                             "proj_kchunk", "n_split", "chunk")],
                ("o", Gemv), ("up", Gemv), ("dn", Gemv),
                *[(f, ctypes.c_float) for f in ("sm_scale", "soft_cap", "qk_eps", "rms_eps")],
                ("qk_norm", ctypes.c_int)]


# each rank's scratch regions of K16's served form (csrc/persistent_decode_v2.cuh)
STREAM_REGIONS = ("x", "att", "act", "q_buf", "k_tok", "v_tok", "part", "part_acc", "part_ml",
                  "land")


class StreamArgs(ctypes.Structure):
    """The launch arguments of K16's served form (csrc/persistent_decode_v2.cuh
    StreamArgs): the team's :class:`CollArgs` (its pad), the layer table and
    each weight kind's per-rank stride, the step's tensors, each rank's
    scratch base and the regions' offsets in it (:data:`STREAM_REGIONS`)."""

    _fields_ = [("c", CollArgs), ("layers", ctypes.c_void_p),
                ("w_stride", ctypes.c_longlong * 8),
                ("x_in", ctypes.c_void_p), ("x_out", ctypes.c_void_p),
                ("pool_k", ctypes.c_void_p), ("pool_v", ctypes.c_void_p),
                ("table", ctypes.c_void_p), ("lens", ctypes.c_void_p),
                ("inv_freq", ctypes.c_void_p), ("scratch", _Peers),
                ("off", ctypes.c_longlong * len(STREAM_REGIONS)),
                ("layer_pool_elems", ctypes.c_longlong),
                *[(f, ctypes.c_int) for f in ("L", "B", "K", "F", "hk", "ps", "mp", "n_split")],
                *[(f, ctypes.c_float) for f in ("sm_scale", "soft_cap", "qk_eps", "rms_eps")],
                ("qk_norm", ctypes.c_int)]


def peers(ptrs) -> _Peers:
    """A peer table of the given addresses (one per mesh slot; none: all null)."""
    p = _Peers()
    for i, v in enumerate(ptrs or ()):
        p.p[i] = v
    return p


def gemm_args(coll: CollArgs, mesh: Mesh, *, a: torch.Tensor | None, b: torch.Tensor,
              y: torch.Tensor, m_loc: int, k: int, n_cols: int) -> GemmArgs:
    """:class:`GemmArgs` around ``coll`` with the peer tables of the
    rank-stacked ``a`` (None: unused), ``b`` and ``y``."""
    return GemmArgs(coll, peers(slot_ptrs(a, mesh) if a is not None else None),
                    peers(slot_ptrs(b, mesh)), peers(slot_ptrs(y, mesh)), m_loc, k, n_cols)


def coll_args(team: Team, mesh: Mesh, *, x: torch.Tensor, out: torch.Tensor,
              land: SymmetricBuffer | None, pad: SymmetricBuffer,
              chunk_elems: int, method: int, stall_rank: int = -1,
              system_scope: bool = False) -> CollArgs:
    """The arguments of one launch over every team of the mesh: the peer
    tables of ``x``, ``out``, the landing slots and the pad, and the team
    layout (``slot[g * n + r]`` is the mesh slot of rank r of team g).
    ``system_scope`` asks K9, K11's one-shot and K17 for their system-scope
    form (the multi-card host); the co-located launch runs at device
    scope."""
    a = CollArgs()
    a.x, a.out = peers(slot_ptrs(x, mesh)), peers(slot_ptrs(out, mesh))
    a.land = peers(land.ptrs() if land is not None else None)
    a.flags = peers(pad.ptrs())
    a.chunk_elems = chunk_elems
    groups = team.groups()
    a.n, a.groups = team.size, len(groups)
    for i, s in enumerate(s for g in groups for s in g):
        a.slot[i] = s
    a.method = method
    a.dtype = DTYPE_CODES.get(x.dtype, -1)
    a.out_dtype = DTYPE_CODES.get(out.dtype, -1)
    a.elsize = x.element_size()
    a.stall_rank = stall_rank
    a.scope = int(system_scope)
    return a


# ---------------------------------------------------------------------------
# waits that ran out


class CollectiveTimeout(RuntimeError):
    """A wait of a collective kernel ran out (about 2 s): the rank that was
    waiting, the flag, and the value it saw against the value it wanted."""


def wait_record() -> dict | None:
    """The record a wait that ran out left in mapped host memory (it reads
    no device state, so it works after the launch has failed), or None."""
    from . import build

    rec = (ctypes.c_int * 8)()
    build.library().tdt_coll_wait_record(rec)
    if not rec[0]:
        return None
    return {"rank": rec[1], "group": rec[2], "slot": rec[3], "lane": rec[4],
            "flag": flag_name(rec[5]), "seen": rec[6], "want": rec[7]}


def raise_if_timed_out() -> None:
    """Raise :class:`CollectiveTimeout` naming the rank and flag if a wait
    of a collective kernel ran out in this process."""
    rec = wait_record()
    if rec is not None:
        raise CollectiveTimeout(
            f"rank {rec['rank']} (team {rec['group']}, mesh slot {rec['slot']}, "
            f"lane {rec['lane']}) waited on flag {rec['flag']}: saw {rec['seen']}, "
            f"wanted {rec['want']}")
