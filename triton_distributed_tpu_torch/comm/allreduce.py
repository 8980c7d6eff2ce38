"""Sum-AllReduce on a mesh of co-located ranks (K11).

Counterpart of ``triton_distributed_tpu/comm/allreduce.py``:

- **ONE_SHOT**: every rank puts its whole partial into its own slot on every
  peer, then sums the n slots locally in f32, in slot order 0..n-1, and
  rounds once to the output dtype (JAX ``blocks.sum_body``).
- **TWO_SHOT**: the ReduceScatter ring (adds in the input dtype), whose last
  step folds the received partial and the local chunk in f32 into
  out-chunk ``me`` (``allreduce.py:176-180``), then the one-way AllGather
  ring of the reduced chunks.  The two phases need no barrier between them:
  the first writes only out-chunk ``me`` and every put of the second is
  gated by its own flag.

Port decisions: the input is rank-stacked ``(*mesh.sizes, M, ...)``, the
result ``(*mesh.sizes, M, ...)``, every rank's copy of the sum.  ``AUTO``
resolves through :func:`choose_method` alone (JAX's tuner comes with the
multi-card host, see ``comm/allgather.py``); TWO_SHOT with M not divisible
by n runs ONE_SHOT, as in JAX.  :class:`AllReduceConfig` is accepted and
its tile unused on the card.  float32 and bfloat16 in and out.  On the card
ONE_SHOT runs at device scope without JAX's entry barrier, each rank's
credits and waits on a thread each (``csrc/ring.cuh::one_shot_phase``,
walked lane by lane in ``comm/lanes.py``); its system-scope form, with the
barrier, is kept for the multi-card host.  The results are the same bits.
"""

from __future__ import annotations

import dataclasses
import enum
import math

import torch

from ..core import symm
from ..core.launches import count
from ..core.mesh import TP_AXIS, Mesh
from ..lang import primitives as dl
from ..lang.primitives import Team
from . import ring
from .launch import check_reduce_dtype, launch, stacked_shard, walk_mesh


class AllReduceMethod(enum.Enum):
    AUTO = "auto"
    ONE_SHOT = "one_shot"   # full-mesh push + local n-way sum (latency)
    TWO_SHOT = "two_shot"   # RS ring + AG ring (bandwidth)


def choose_method(nbytes_per_rank: int, num_ranks: int) -> AllReduceMethod:
    """JAX's size rule: one-shot for two ranks or partials up to
    ``one_shot_bytes_threshold()``, else two-shot."""
    from ..tools import calibrate

    if num_ranks <= 2 or nbytes_per_rank <= calibrate.one_shot_bytes_threshold():
        return AllReduceMethod.ONE_SHOT
    return AllReduceMethod.TWO_SHOT


@dataclasses.dataclass(frozen=True)
class AllReduceConfig:
    bm: int = 256   # JAX's reduction-pipeline tile; not used by the kernel
    bn: int = 512


def one_shot_program(team: Team, me: int) -> list:
    """JAX ``_ar_one_shot_kernel``'s schedule."""
    prog = []
    ring.push_phase(prog, team, me, "slots")
    prog.append(dl.Reduce(("out", 0), tuple(("slots", i) for i in range(team.size)), True))
    return prog


def two_shot_program(team: Team, me: int) -> list:
    """JAX ``_ar_two_shot_kernel``'s schedule."""
    prog = []
    dl.collective_prologue(prog, team, me, neighbors_only=True)
    ring.rs_ring_phase(prog, team, me, ("out", me), last_f32=True)
    ring.ag_ring_phase(prog, team, me)
    ring.rs_ack_drain(prog, team.size)
    return prog


PROGRAMS = {AllReduceMethod.ONE_SHOT: one_shot_program,
            AllReduceMethod.TWO_SHOT: two_shot_program}
_CODES = {AllReduceMethod.ONE_SHOT: 0, AllReduceMethod.TWO_SHOT: 1}


def resolve_method(method: AllReduceMethod, m: int, row_bytes: int,
                   num_ranks: int) -> AllReduceMethod:
    """AUTO by the partial's bytes; TWO_SHOT needs M divisible by n (it
    chunks rows n ways) and otherwise runs ONE_SHOT, as in JAX."""
    if method == AllReduceMethod.AUTO:
        method = choose_method(m * row_bytes, num_ranks)
    if method == AllReduceMethod.TWO_SHOT and m % num_ranks:
        method = AllReduceMethod.ONE_SHOT
    return method


def _setup(x: torch.Tensor, mesh: Mesh, axis: str, method: AllReduceMethod, out_dtype):
    shard = stacked_shard(x, mesh, axis)
    team = Team.of(mesh, axis)
    out = torch.empty((*mesh.sizes, *shard), dtype=out_dtype, device=x.device)
    two = method == AllReduceMethod.TWO_SHOT
    landing = {"recv": 2} if two else {"slots": team.size}
    return team, x.contiguous(), out, math.prod(shard) // (team.size if two else 1), landing


def all_reduce_ref(x: torch.Tensor, mesh: Mesh, axis: str = TP_AXIS,
                   method: AllReduceMethod = AllReduceMethod.ONE_SHOT,
                   out_dtype=None) -> torch.Tensor:
    """Plain version of K11, on any device: ``method``'s schedule walked on
    tensors (f32 sums where JAX sums in f32, input-dtype adds where it adds
    in the input dtype)."""
    team, x, out, chunk_elems, landing = _setup(x, mesh, axis, method, out_dtype or x.dtype)
    if chunk_elems:
        walk_mesh(PROGRAMS[method], team, mesh, x, out, chunk_elems, landing)
    return out


def _all_reduce(x: torch.Tensor, mesh: Mesh, axis: str, method: AllReduceMethod,
                out_dtype, *, system_scope: bool = False, stall_rank: int = -1) -> torch.Tensor:
    """K11 for a CUDA tensor, the plain version for a CPU one.
    ``system_scope``: the one-shot's system-scope form (with the entry
    barrier), kept for the multi-card host (ROADMAP A11); ``stall_rank`` >=
    0 (tests of the bounded waits only): that rank credits no arrival."""
    if not x.is_cuda:
        return all_reduce_ref(x, mesh, axis, method, out_dtype)
    team, x, out, chunk_elems, landing = _setup(x, mesh, axis, method, out_dtype)
    if chunk_elems:
        (name, entries), = landing.items()
        land = symm.landing(mesh, axis, f"allreduce_{name}", (entries, chunk_elems), x.dtype)
        launch("tdt_all_reduce", "allreduce", team, mesh, x, out, land, chunk_elems,
               _CODES[method], stall_rank, system_scope)
        count("all_reduce", (method.value, team.size, tuple(x.shape[len(mesh.axes):])))
    return out


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str = TP_AXIS, *,
               method: AllReduceMethod = AllReduceMethod.AUTO,
               config: AllReduceConfig | None = None, out_dtype=None,
               wire_dtype: str = "bf16") -> torch.Tensor:
    """Sum-AllReduce over ``axis``.

    ``x``: rank-stacked ``(*mesh.sizes, M, ...)``, each rank's partial
    addend.  Returns ``(*mesh.sizes, M, ...)`` in ``out_dtype`` (x's by
    default): every rank holds the element-wise sum of its team's partials
    (golden: ``x.reshape(n, M, ...).sum(0)``).  ONE_SHOT sums in f32;
    TWO_SHOT adds the ring's hops in the input dtype and only the last fold
    in f32, as JAX does, so bf16 results differ slightly across the size
    threshold.  ``n == 1`` returns ``x`` in ``out_dtype``."""
    del config
    shard = stacked_shard(x, mesh, axis, wire_dtype)
    out_dtype = out_dtype or x.dtype
    check_reduce_dtype(x, out_dtype)
    n = mesh.shape[axis]
    if n == 1:
        return x.to(out_dtype)
    row_bytes = math.prod(shard[1:]) * x.dtype.itemsize
    return _all_reduce(x, mesh, axis, resolve_method(method, shard[0], row_bytes, n),
                       out_dtype)
