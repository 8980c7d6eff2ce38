"""Teams, and the host-side mirror of the device vocabulary of the
collectives.

Counterpart of ``triton_distributed_tpu/lang/primitives.py``.  The device
vocabulary itself is ``csrc/dl.cuh``: ``notify`` (a release atomic add of
one at system scope), ``wait`` (an acquire spin until a flag reaches a value, which
it then subtracts: the TPU's counting-semaphore semantics), ``put`` (a
block-cooperative copy into a peer's buffer, then a fence), and the
barriers.  This module keeps:

- :class:`Team`, the communicator over one mesh axis, with its ring
  arithmetic (``device_id`` maps a team rank to a mesh slot);
- the ops a rank's program is made of (:class:`Put`, :class:`Notify`,
  :class:`Wait`, :class:`Reduce`, and the overlapped GEMMs' :class:`Matmul`)
  and the barriers, as Python records.  A
  collective's schedule is a list of them per rank (``comm/ring.py`` and the
  bodies in ``comm/``); its plain version walks those lists
  (``comm/ring.py::walk``) and its kernel runs the same steps on the card.

Send semaphores are gone: JAX waits for a remote DMA's send completion
(``wait_send``) before it reuses the source, but a put here is made by the
block's own stores, which are done when the put returns.  Every receive
count and every ACK credit of the JAX schedules stays (on the card K17 and
K11's one-shot credit once per lane and peer instead: ``comm/lanes.py``).
"""

from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------------------
# teams


@dataclasses.dataclass(frozen=True)
class Team:
    """A communicator over one mesh axis.

    ``axes`` is the whole mesh, (name, size) outermost first; the team's
    members are the ranks that share every coordinate but ``axis``.  A rank
    is addressed by its mesh slot (row-major over ``axes``), as the JAX
    package addresses a device by its logical id."""

    axes: tuple[tuple[str, int], ...]
    axis: str

    @classmethod
    def of(cls, mesh, axis: str) -> "Team":
        if axis not in dict(mesh.axes):
            raise ValueError(f"axis {axis!r} is not on the mesh {dict(mesh.axes)}")
        return cls(tuple(mesh.axes), axis)

    @property
    def size(self) -> int:
        return dict(self.axes)[self.axis]

    def _coords(self, slot: int) -> list[int]:
        out = []
        for _, size in reversed(self.axes):
            out.append(slot % size)
            slot //= size
        return out[::-1]

    def rank(self, slot: int) -> int:
        """The team rank of the rank at mesh slot ``slot``."""
        return self._coords(slot)[[n for n, _ in self.axes].index(self.axis)]

    def device_id(self, peer_rank: int, slot: int) -> int:
        """Mesh slot of team member ``peer_rank`` in the team of the rank at
        ``slot`` (JAX ``Team.device_id``: every other coordinate stays)."""
        coords = self._coords(slot)
        coords[[n for n, _ in self.axes].index(self.axis)] = peer_rank
        lid = 0
        for (_, size), c in zip(self.axes, coords):
            lid = lid * size + c
        return lid

    def groups(self) -> list[list[int]]:
        """The mesh slots of each team, by team rank, teams in slot order of
        their rank 0 (a kernel launch carries them all: ``blockIdx.y`` is
        ``group * size + rank``)."""
        total = 1
        for _, size in self.axes:
            total *= size
        firsts = [s for s in range(total) if self.rank(s) == 0]
        return [[self.device_id(r, s) for r in range(self.size)] for s in firsts]

    def neighbor_ranks(self, me: int) -> tuple[int, int]:
        """(left, right) team ranks on the ring."""
        n = self.size
        return (me + n - 1) % n, (me + 1) % n


def ring_src_rank(team: Team, me: int, step: int) -> int:
    """Rank whose chunk arrives at ``me`` after ``step`` forwarding hops in a
    +1 ring (the chunk's origin at ring distance step + 1 to the left)."""
    n = team.size
    return (me + 2 * n - step - 1) % n


# ---------------------------------------------------------------------------
# the ops of a rank's program
#
# A flag is (name, index), one per rank and per lane of a launch
# (``csrc/dl.cuh``): "barrier" (0), "rs_recv" (the two receive slots of the
# ReduceScatter ring), "ack" (their consumption credits) and "recv" (one per
# chunk or one-shot slot).  FLAG_IDS is the flag's offset in a lane's row of
# the signal pad, the same numbers as csrc/dl.cuh.

FLAGS_PER_LANE = 32
FLAG_IDS = {("barrier", 0): 0, ("rs_recv", 0): 1, ("rs_recv", 1): 2,
            ("ack", 0): 3, ("ack", 1): 4,
            # the rank-wide barrier of K14-K16, in lane 0's row only
            # (csrc/dl.cuh rank_sync): lanes arrived, lanes past the
            # launch's last one
            ("sync_arrive", 0): 5, ("sync_leave", 0): 6,
            **{("recv", c): 8 + c for c in range(8)},
            # K12, in lane 0's row only: lanes whose slice of chunk c is here,
            # lanes past their last read of those counts
            **{("ready", c): 16 + c for c in range(8)}, ("ready_leave", 0): 24}
FLAG_NAMES = {v: f"{name}[{i}]" for (name, i), v in FLAG_IDS.items()}
# K13's (hop, tile) flags fill the pads' second half; a wait on flag i of
# them that runs out records TILE_FLAG_ID + i (csrc/dl.cuh kTileId)
TILE_FLAG_ID = 1 << 16


def flag_name(flag_id: int) -> str:
    """The name of a flag id as a wait record gives it."""
    if flag_id >= TILE_FLAG_ID:
        return f"tile[{flag_id - TILE_FLAG_ID}]"
    return FLAG_NAMES.get(flag_id, str(flag_id))


@dataclasses.dataclass(frozen=True)
class Put:
    """Write ``srcs`` (local (buffer, index) pairs; two are added in the
    input dtype first, JAX ``blocks.add_body``) into entry ``index`` of
    buffer ``dst`` of team member ``dst_rank``, then credit that member's
    ``flag`` with one arrival (None for a put to oneself, which nobody
    waits for)."""

    dst: str
    index: int
    dst_rank: int
    srcs: tuple[tuple[str, int], ...]
    flag: tuple[str, int] | None


@dataclasses.dataclass(frozen=True)
class Notify:
    """Credit ``target``'s ``flag`` by one."""

    flag: tuple[str, int]
    target: int


@dataclasses.dataclass(frozen=True)
class Wait:
    """Block until one's own ``flag`` reaches ``count``, then take
    ``count`` off it."""

    flag: tuple[str, int]
    count: int


@dataclasses.dataclass(frozen=True)
class Reduce:
    """Local: the sum of ``srcs`` into entry ``dst`` of one's own buffer.
    ``f32``: accumulated in f32 in the order given and rounded once to the
    output dtype (JAX ``blocks.sum_body``); else added in the input dtype
    (``blocks.add_body``)."""

    dst: tuple[str, int]
    srcs: tuple[tuple[str, int], ...]
    f32: bool


@dataclasses.dataclass(frozen=True)
class Matmul:
    """Local: entry ``src`` (rows of A) times entry ``w`` of this rank's
    weights (the overlapped GEMMs' B is entry ("b", 0); the column-chunked
    ring's chunk j of W is ("w", j)), accumulated in f32 and rounded once
    to the dtype of entry ``dst`` (JAX ``blocks.matmul_body``), into
    ``dst``.  The fused GEMMs' compute step; on the card every lane of the
    rank takes its part of it."""

    dst: tuple[str, int]
    src: tuple[str, int]
    w: tuple[str, int] = ("b", 0)


@dataclasses.dataclass(frozen=True)
class Swiglu:
    """Local: ``silu(g) * u`` of entries ``g`` and ``u``, in f32, rounded
    once to the dtype of entry ``dst`` (JAX ``blocks.swiglu_body`` as
    ``_mlp_act_host`` rounds it): K15's prologue."""

    dst: tuple[str, int]
    g: tuple[str, int]
    u: tuple[str, int]


def put(prog: list, dst: str, index: int, dst_rank: int, srcs, flag=None) -> None:
    prog.append(Put(dst, index, dst_rank, tuple(srcs), flag))


def notify(prog: list, flag, target: int) -> None:
    prog.append(Notify(flag, target))


def wait(prog: list, flag, count: int = 1) -> None:
    prog.append(Wait(flag, count))


# ---------------------------------------------------------------------------
# barriers (JAX primitives.py:488-600)

BARRIER = ("barrier", 0)


def barrier_all(prog: list, team: Team, me: int) -> None:
    """Hub barrier: every rank but 0 credits rank 0 and waits for its
    release; rank 0 waits for n - 1 arrivals, then releases each.  Arrivals
    only ever reach rank 0 and releases only the others, so a fast rank's
    next round cannot satisfy a slow rank's wait."""
    n = team.size
    if n == 1:
        return
    if me != 0:
        notify(prog, BARRIER, 0)
        wait(prog, BARRIER, 1)
    else:
        wait(prog, BARRIER, n - 1)
        for i in range(1, n):
            notify(prog, BARRIER, i)


def barrier_neighbors(prog: list, team: Team, me: int) -> None:
    """Credit both ring neighbours, wait for both credits (no round
    separation: enough for rings whose every chunk is gated by its own
    flag)."""
    if team.size == 1:
        return
    left, right = team.neighbor_ranks(me)
    notify(prog, BARRIER, left)
    notify(prog, BARRIER, right)
    wait(prog, BARRIER, 2)


def collective_prologue(prog: list, team: Team, me: int, *,
                        neighbors_only: bool = False) -> None:
    """The entry barrier of every collective, before its first remote put."""
    (barrier_neighbors if neighbors_only else barrier_all)(prog, team, me)
