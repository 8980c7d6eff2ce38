"""K12's and K13's lanes and tiles on the card, as a walk.

The rank-level schedules (``comm/ring.py``, walked by the plain versions)
say which chunk goes where at which step.  On the card a rank is many
lanes (blocks), and ``csrc/overlap_gemm.cu`` runs those schedules tile by
tile with no barrier between a rank's lanes.  This module mirrors that
protocol: which lane takes which tile in what order, what it waits on and
what it credits, and :func:`walk` runs it on tensors under a seeded random
interleaving of the lanes, checking as it goes that

- no tile reads rows (K12) or a partial (K13) that has not arrived,
- no lane blocks forever (a round in which nothing can move raises),
- every flag of the pads is back at zero at the end.

Each lane of a rank is two agents, as on the card:

- K12 (``ag_gemm_kernel``): the *copy* agent (the block's three spare
  warps) passes the neighbours' barrier and runs the ring of K9 on its
  slices (one-way or two-way; the own shard sent on straight from ``x``,
  both ways in one pass; in the two-way ring a step takes both arrivals
  before either forward), raising ``ready[r]`` on its own rank as soon as
  its slice of chunk r has arrived; last it copies its slice of the own
  shard into gathered chunk ``me``, which no tile reads.  The *tile* agent
  (the TMA producer and the wgmma consumers) takes tiles ``lane, lane +
  lanes, ...`` of the rank's sequence (chunks in arrival order, every tile
  of a chunk): chunk ``me``'s tiles read the rank's own shard in place, and
  before the first tile of any other chunk r it waits until ``ready[r]``
  counts every lane.  After both agents are done the lane leaves; the last
  lane out clears the counts.
- K13 (``gemm_rs_kernel``): the *prologue* agent passes the neighbours'
  barrier, then signals the block (``start``, shared memory).  The *tile*
  agent takes tiles of the hop-major sequence (hop s, tile t at ``s T +
  t``): the product of chunk ``me - s - 1``'s tile t, rounded to the output
  dtype; at s > 0 it waits for ``tile[(s - 1) T + t]``, adds the left
  neighbour's partial from landing slot s - 1 in f32 and rounds once; it
  writes into the right neighbour's slot s and credits ``tile[s T + t]``
  there, or into its own output at the last hop.

Slices are ``dl.cuh``'s ``Rank::slice`` (16-element groups, in elements),
tiles ``overlap_gemm.cu``'s ``Tiles`` (m-major); the tile shape is a
parameter (the card's are :data:`TILES`).
"""

from __future__ import annotations

import collections
import dataclasses
import random

import torch

from ..core.symm import MAX_LANES
from ..lang.primitives import FLAGS_PER_LANE

# csrc/overlap_gemm.cu Tiles<T>: (BM, BN) of each operand dtype's main loop
TILES = {torch.bfloat16: (128, 256), torch.float32: (64, 64)}
# csrc/dl.cuh kTileFlags: K13's (hop, tile) flags fill the pads' second half
TILE_FLAGS = MAX_LANES * FLAGS_PER_LANE // 2


@dataclasses.dataclass(frozen=True)
class Grid:
    """The tiles of one chunk's (rows, cols) product, ``bm`` x ``bn``,
    m-major: tile t is at (``m0(t)``, ``n0(t)``)."""

    rows: int
    cols: int
    bm: int
    bn: int

    @property
    def tm(self) -> int:
        return -(-self.rows // self.bm)

    @property
    def count(self) -> int:
        return self.tm * -(-self.cols // self.bn)

    def m0(self, t: int) -> int:
        return (t % self.tm) * self.bm

    def n0(self, t: int) -> int:
        return (t // self.tm) * self.bn


def check_tile_flags(n: int, m_loc: int, cols: int, dtype) -> None:
    """K13 keeps one flag per (hop, tile) in the pads' second half: raise if
    a call needs more than :data:`TILE_FLAGS`."""
    bm, bn = TILES[dtype]
    need = (n - 1) * Grid(m_loc, cols, bm, bn).count
    if need > TILE_FLAGS:
        raise ValueError(f"GEMM-RS of {n} chunks of {m_loc} x {cols} needs {need} tile flags; "
                         f"the signal pads hold {TILE_FLAGS}")


def lane_slice(elems: int, lanes: int, lane: int, quantum: int = 16) -> tuple[int, int]:
    """[lo, hi) of ``lane``'s slice of a chunk of ``elems`` elements
    (``dl.cuh`` ``Rank::slice``)."""
    per_lane = -(-(-(-elems // quantum)) // lanes) * quantum
    return min(elems, per_lane * lane), min(elems, per_lane * (lane + 1))


def ag_chunk(me: int, n: int, ci: int, bidir: bool) -> int:
    """The ci-th chunk to arrive at rank ``me`` (``overlap_gemm.cu``
    ``ag_chunk``): one's own, then one-way me - 1, me - 2, ...; two-way
    me - 1, me + 1, me - 2, ..."""
    if not bidir or ci == 0:
        return (me - ci) % n
    s = (ci - 1) // 2
    return (me - s - 1) % n if ci % 2 else (me + s + 1) % n


def rs_chunk(me: int, n: int, s: int) -> int:
    """The chunk K13's rank ``me`` adds at hop s: me - s - 1."""
    return (me - s - 1) % n


# ---------------------------------------------------------------------------
# the ops of an agent.  A flag is a tuple: ("pad", rank, ...) lives in a
# rank's signal pad (and must end at zero), ("smem", rank, lane, ...) in a
# block's shared memory.


@dataclasses.dataclass(frozen=True)
class Credit:
    flag: tuple


@dataclasses.dataclass(frozen=True)
class Wait:
    """Block until ``flag`` reaches ``count``; ``take`` then subtracts it
    (a count that many lanes read is only waited on)."""

    flag: tuple
    count: int
    take: bool = True


@dataclasses.dataclass(frozen=True)
class Copy:
    """Elements [lo, hi) of chunk ``src`` into chunk ``dst``: (rank, buffer,
    chunk) each."""

    src: tuple
    dst: tuple
    lo: int
    hi: int


@dataclasses.dataclass(frozen=True)
class AgTile:
    """K12: tile t of gathered chunk ``chunk`` times B into C."""

    rank: int
    chunk: int
    t: int


@dataclasses.dataclass(frozen=True)
class RsTile:
    """K13: hop s, tile t (of chunk ``rs_chunk(rank, n, s)``)."""

    rank: int
    s: int
    t: int


@dataclasses.dataclass(frozen=True)
class Join:
    """Block until the other agents of this lane are done."""


@dataclasses.dataclass(frozen=True)
class Leave:
    """The lane is past its last read of the ready counts: count it out; the
    last lane of the rank clears the counts."""

    rank: int


@dataclasses.dataclass
class Agent:
    rank: int
    lane: int
    role: str
    ops: list
    pc: int = 0

    @property
    def done(self) -> bool:
        return self.pc >= len(self.ops)


def _barrier(me: int, n: int, lane: int) -> list:
    """The neighbours' barrier of a lane (``collective_prologue``)."""
    left, right = (me - 1) % n, (me + 1) % n
    return [Credit(("pad", left, lane, "barrier")), Credit(("pad", right, lane, "barrier")),
            Wait(("pad", me, lane, "barrier"), 2)]


def ag_agents(n: int, lanes: int, grid: Grid, k: int, bidir: bool,
              stall_rank: int = -1, skip_ready: bool = False) -> list[Agent]:
    """K12's agents over a team of n ranks, ``lanes`` lanes a rank; a chunk
    is ``grid.rows`` x ``k``.  ``stall_rank`` credits no arrival (the bounded
    waits' tests); ``skip_ready`` drops the tiles' ready waits (a fault the
    walk must catch)."""
    agents = []
    elems = grid.rows * k
    for me in range(n):
        left, right = (me - 1) % n, (me + 1) % n
        for lane in range(lanes):
            lo, hi = lane_slice(elems, lanes, lane)
            ops = _barrier(me, n, lane)

            def send(r, dst, ops=ops, me=me, lane=lane, lo=lo, hi=hi):
                src = (me, "x", 0) if r == me else (me, "ag", r)
                ops.append(Copy(src, (dst, "ag", r), lo, hi))
                if me != stall_rank:
                    ops.append(Credit(("pad", dst, lane, "recv", r)))

            def arrive(r, ops=ops, me=me, lane=lane):
                ops.append(Wait(("pad", me, lane, "recv", r), 1))
                ops.append(Credit(("pad", me, "ready", r)))

            if not bidir:
                for step in range(n - 1):
                    send((me - step) % n, right)
                    arrive((me - step - 1) % n)
            else:   # the own shard both ways, then both arrivals before the forwards
                n_cw, n_ccw = n // 2, (n - 1) // 2
                send(me, right)
                if n_ccw >= 1:
                    send(me, left)
                for step in range(max(n_cw, n_ccw)):
                    cw, ccw = (me - step - 1) % n, (me + step + 1) % n
                    if step < n_cw:
                        arrive(cw)
                    if step < n_ccw:
                        arrive(ccw)
                    if step + 1 < n_cw:
                        send(cw, right)
                    if step + 1 < n_ccw:
                        send(ccw, left)
            ops.append(Copy((me, "x", 0), (me, "ag", me), lo, hi))
            agents.append(Agent(me, lane, "copy", ops))
            tiles, seen = [], 0
            for i in range(lane, n * grid.count, lanes):
                ci, t = divmod(i, grid.count)
                r = ag_chunk(me, n, ci, bidir)
                if ci != seen and not skip_ready:
                    tiles.append(Wait(("pad", me, "ready", r), lanes, take=False))
                seen = ci
                tiles.append(AgTile(me, r, t))
            agents.append(Agent(me, lane, "tile", [*tiles, Join(), Leave(me)]))
    return agents


def rs_agents(n: int, lanes: int, grid: Grid, stall_rank: int = -1,
              skip_tile_wait: bool = False) -> list[Agent]:
    """K13's agents over a team of n ranks, ``lanes`` lanes a rank, chunks
    of ``grid.rows`` rows.  ``skip_tile_wait`` drops the partials' waits (a
    fault the walk must catch)."""
    agents = []
    for me in range(n):
        right = (me + 1) % n
        for lane in range(lanes):
            start = ("smem", me, lane, "start")
            agents.append(Agent(me, lane, "prologue", [*_barrier(me, n, lane), Credit(start)]))
            ops = []
            for i in range(lane, n * grid.count, lanes):
                s, t = divmod(i, grid.count)
                ops.append(Wait(start, 1, take=False))
                if s > 0 and not skip_tile_wait:
                    ops.append(Wait(("pad", me, "tile", (s - 1) * grid.count + t), 1))
                ops.append(RsTile(me, s, t))
                if s < n - 1 and me != stall_rank:
                    ops.append(Credit(("pad", right, "tile", s * grid.count + t)))
            agents.append(Agent(me, lane, "tile", ops))
    return agents


# ---------------------------------------------------------------------------
# the walk


class ProtocolError(RuntimeError):
    """A tile read what had not arrived, the lanes deadlocked, or a flag was
    left non-zero."""


def _covered(have: list[tuple[int, int]], lo: int, hi: int) -> bool:
    pos = lo
    for a, b in sorted(have):
        if a <= pos < b:
            pos = b
    return pos >= hi


class _State:
    def __init__(self, bufs, grid: Grid, n: int, lanes: int):
        self.bufs, self.grid, self.n, self.lanes = bufs, grid, n, lanes
        self.flags: collections.Counter = collections.Counter()
        self.here = collections.defaultdict(list)   # (rank, buffer, chunk) -> [lo, hi) runs
        self.partials = set()                        # (rank, slot, tile) written

    def tile_box(self, t: int):
        g = self.grid
        m0, n0 = g.m0(t), g.n0(t)
        return slice(m0, min(m0 + g.bm, g.rows)), slice(n0, min(n0 + g.bn, g.cols))

    def run(self, op, agent: Agent, agents: list[Agent]) -> bool:
        """Run ``op``; False if it blocks."""
        b = self.bufs
        if isinstance(op, Wait):
            if self.flags[op.flag] < op.count:
                return False
            if op.take:
                self.flags[op.flag] -= op.count
        elif isinstance(op, Credit):
            self.flags[op.flag] += 1
        elif isinstance(op, Join):
            if not all(a.done for a in agents
                       if a.rank == agent.rank and a.lane == agent.lane and a is not agent):
                return False
        elif isinstance(op, Leave):
            key = ("pad", op.rank, "ready_leave")
            self.flags[key] += 1
            if self.flags[key] == self.lanes:
                for r in range(self.n):
                    self.flags[("pad", op.rank, "ready", r)] = 0
                self.flags[key] = 0
        elif isinstance(op, Copy):
            (sr, sb, sc), (dr, db, dc) = op.src, op.dst
            if sb != "x" and not _covered(self.here[op.src], op.lo, op.hi):
                raise ProtocolError(f"{agent.role} agent of rank {agent.rank} lane {agent.lane} "
                                    f"forwards elements [{op.lo}, {op.hi}) of {op.src} "
                                    "before they arrived")
            b[dr][db][dc].view(-1)[op.lo:op.hi] = b[sr][sb][sc].view(-1)[op.lo:op.hi]
            self.here[op.dst].append((op.lo, op.hi))
        elif isinstance(op, AgTile):
            rows, cols = self.tile_box(op.t)
            k = b[op.rank]["x"][0].shape[-1]
            if op.chunk == op.rank:   # the own shard, read in place
                a = b[op.rank]["x"][0][rows]
            elif not _covered(self.here[(op.rank, "ag", op.chunk)], rows.start * k,
                              rows.stop * k):
                raise ProtocolError(f"rank {op.rank} lane {agent.lane} reads rows "
                                    f"[{rows.start}, {rows.stop}) of chunk {op.chunk} before "
                                    "they arrived")
            else:
                a = b[op.rank]["ag"][op.chunk][rows]
            c = b[op.rank]["c"][op.chunk]
            c[rows, cols] = torch.matmul(a.float(), b[op.rank]["b"][0][:, cols].float())
        elif isinstance(op, RsTile):
            self._rs_tile(op, agent)
        return True

    def _rs_tile(self, op: RsTile, agent: Agent) -> None:
        b, n = self.bufs, self.n
        rows, cols = self.tile_box(op.t)
        j = rs_chunk(op.rank, n, op.s)
        a = b[op.rank]["a"][j][rows]
        prod = torch.matmul(a.float(), b[op.rank]["b"][0][:, cols].float())
        out = b[op.rank]["out"][0]
        val = prod.to(out.dtype)
        if op.s > 0:
            if (op.rank, op.s - 1, op.t) not in self.partials:
                raise ProtocolError(f"rank {op.rank} lane {agent.lane} adds hop {op.s - 1}'s "
                                    f"partial of tile {op.t} before it arrived")
            val = (b[op.rank]["land"][op.s - 1][rows, cols].float() + val.float()).to(out.dtype)
        if op.s < n - 1:
            right = (op.rank + 1) % n
            b[right]["land"][op.s][rows, cols] = val
            self.partials.add((right, op.s, op.t))
        else:
            out[rows, cols] = val


def tiles_first(agent: Agent) -> tuple:
    """A priority for :func:`walk`: tile agents before the others, higher
    ranks first (the order in which a missing wait shows at once)."""
    return agent.role != "tile", -agent.rank


def walk(agents: list[Agent], state: _State, seed: int, prefer=None) -> None:
    """Run the agents one op at a time, the next agent drawn at random (seeded)
    among those that can move (ordered by the key ``prefer``, when given);
    raise :class:`ProtocolError` on a deadlock or a pad flag left non-zero."""
    rng = random.Random(seed)
    live = list(agents)
    while live:
        order = live[:]
        rng.shuffle(order)
        if prefer is not None:
            order.sort(key=prefer)
        for agent in order:
            if state.run(agent.ops[agent.pc], agent, agents):
                agent.pc += 1
                break
        else:
            stuck = {(a.rank, a.lane, a.role): a.ops[a.pc] for a in live}
            raise ProtocolError(f"the lanes deadlock: {stuck}")
        live = [a for a in live if not a.done]
    left = {f: v for f, v in state.flags.items() if f[0] == "pad" and v}
    if left:
        raise ProtocolError(f"flags left non-zero: {left}")


def walk_ag_gemm(a: torch.Tensor, b: torch.Tensor, lanes: int, tile: tuple[int, int], *,
                 bidir: bool, out_dtype=None, seed: int = 0, **faults):
    """K12's protocol walked on rank-stacked a (n, m_loc, K) and b (n, K,
    n_loc): returns (C (n, n m_loc, n_loc), the gathered A (n, n m_loc,
    K)).  The gathered chunks start as NaN."""
    n, m_loc, k = a.shape
    grid = Grid(m_loc, b.shape[-1], *tile)
    out_dtype = out_dtype or a.dtype
    gathered = torch.full((n, n * m_loc, k), float("nan"), dtype=a.dtype)
    c = torch.full((n, n * m_loc, b.shape[-1]), float("nan"), dtype=out_dtype)
    bufs = [{"x": [a[r]], "b": [b[r]], "ag": list(gathered[r].split(m_loc)),
             "c": list(c[r].split(m_loc))} for r in range(n)]
    state = _State(bufs, grid, n, lanes)
    walk(ag_agents(n, lanes, grid, k, bidir, **faults), state, seed,
         prefer=tiles_first if faults.get("skip_ready") else None)
    return c, gathered


def walk_gemm_rs(a: torch.Tensor, b: torch.Tensor, lanes: int, tile: tuple[int, int], *,
                 out_dtype=None, seed: int = 0, **faults) -> torch.Tensor:
    """K13's protocol walked on rank-stacked a (n, M, k_loc) and b (n, k_loc,
    N): returns (n, M / n, N), rank r's rows of the sum.  The landing slots
    start as NaN."""
    n, m, _ = a.shape
    m_loc, cols = m // n, b.shape[-1]
    grid = Grid(m_loc, cols, *tile)
    out_dtype = out_dtype or a.dtype
    out = torch.full((n, m_loc, cols), float("nan"), dtype=out_dtype)
    bufs = [{"a": list(a[r].split(m_loc)), "b": [b[r]], "out": [out[r]],
             "land": list(torch.full((n - 1, m_loc, cols), float("nan"), dtype=out_dtype))}
            for r in range(n)]
    state = _State(bufs, grid, n, lanes)
    walk(rs_agents(n, lanes, grid, **faults), state, seed,
         prefer=tiles_first if faults.get("skip_tile_wait") else None)
    return out
