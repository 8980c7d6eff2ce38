"""K17's, K11's one-shot and K9's lanes on the card, as a walk.

The rank-level schedules (``comm/ring.py``: ``a2a_push_phase``, ``push_phase``,
the AllGather rings) say what goes where; the plain versions walk them.  On
the card a rank is many lanes (blocks), and since their redesign
``csrc/all_to_all.cu``, ``csrc/ring.cuh::one_shot_phase`` and K9's
device-scope forms credit and wait lane by lane in a way those schedules do
not show.  This module mirrors that protocol, and :func:`comm.tiles.walk`
runs it on tensors under a seeded random interleaving of the lanes,
checking that no lane reads, forwards (K9's rings, K11) or is told of (K9,
K17) a slice that has not arrived, that no lane blocks forever, and that
every flag of the pads is back at zero.

- **K17** (``a2a_push_kernel``): each lane takes a contiguous share of the
  rows each destination gets (``share``: a lane past a small count takes
  none), copies its shares in the emission order, then credits every
  destination's ``recv[me]`` in its own row once, a share of zero rows
  included, and waits once on each source's ``recv[source]``, whatever the
  counts; after each wait the source's share for this lane must be in its
  zone.
- **K11's one-shot** (``one_shot_phase``): each lane copies its slice of
  the partial into slot ``me`` of every peer, credits each peer's
  ``recv[me]``, waits once on each peer's, then sums the n slices in slot
  order in f32 (its own from ``x``), rounded once.
- **K9** (``csrc/collectives.cu`` ``all_gather_kernel`` at device scope):
  the push (``push_each_phase``) copies its lane's slice of the shard into
  out-chunk ``me`` of every rank, itself included, credits each peer's
  ``recv[me]`` once and waits once on each peer's; the one-way ring's first
  put reads ``x`` into out-chunk ``me`` here and on the right neighbour at
  once, and each later hop forwards the chunk that just arrived behind its
  own credit (``ag_ring_phase`` with ``FROM_X``); the two-way ring sends its
  shard both ways in that first pass (``bidir_ring_phase``).  Every slice of
  every peer's chunk must be here when the lane ends.

The system-scope forms (the multi-card host) add JAX's entry barrier first,
lane by lane: the hub barrier (K17, K11's one-shot, K9's push, which copies
its own chunk before it), the neighbours' barrier (K9's rings, after the
own chunk).  Shares are in 16-byte units (K17: ``unit`` elements of a row
of a multiple of 16 bytes), slices are ``dl.cuh``'s ``Rank::slice``
(:func:`comm.tiles.lane_slice`; K9 cuts bytes at its unit, 16, 4 or 1
bytes).  The lanes are a parameter: on the card K17 takes as many as the
card holds at once, capped by a full zone at four 16-byte vectors a thread,
and K11's one-shot and K9 one unit a thread (:func:`gather_lanes`).
"""

from __future__ import annotations

import dataclasses

import torch

from .tiles import (Agent, Copy, Credit, ProtocolError, Wait, _barrier, _covered, _State,
                    lane_slice, walk)

# csrc/dl.cuh kThreads: K9's and K11's one-shot device-scope forms move one
# unit a thread
THREADS = 256


def share(units: int, lanes: int, lane: int) -> tuple[int, int]:
    """[lo, hi) of ``lane``'s contiguous share of ``units`` (K17)."""
    per = -(-units // lanes)
    return min(units, per * lane), min(units, per * (lane + 1))


@dataclasses.dataclass(frozen=True)
class Arrived:
    """Elements [lo, hi) of (rank, buffer, entry) must be here."""

    entry: tuple
    lo: int
    hi: int


@dataclasses.dataclass(frozen=True)
class SlotSum:
    """K11: elements [lo, hi) of rank's out = the f32 sum of the n slots in
    slot order (slot ``rank`` read from x), rounded once."""

    rank: int
    lo: int
    hi: int


class _LaneState(_State):
    def __init__(self, bufs, n: int, lanes: int):
        super().__init__(bufs, None, n, lanes)

    def _check(self, entry, lo, hi, agent, what: str) -> None:
        if hi > lo and not _covered(self.here[entry], lo, hi):
            raise ProtocolError(f"rank {agent.rank} lane {agent.lane} {what} elements "
                                f"[{lo}, {hi}) of {entry} before they arrived")

    def run(self, op, agent: Agent, agents: list[Agent]) -> bool:
        if isinstance(op, Arrived):
            self._check(op.entry, op.lo, op.hi, agent, "was told of")
            return True
        if isinstance(op, SlotSum):
            b, r = self.bufs, op.rank
            acc = None
            for i in range(self.n):
                if i == r:
                    v = b[r]["x"][0]
                else:
                    self._check((r, "slots", i), op.lo, op.hi, agent, "sums")
                    v = b[r]["slots"][i]
                v = v.reshape(-1)[op.lo:op.hi].float()
                acc = v if acc is None else acc + v
            b[r]["out"][0].view(-1)[op.lo:op.hi] = acc
            return True
        return super().run(op, agent, agents)


def _hub_barrier(me: int, n: int, lane: int) -> list:
    """JAX's hub barrier of a lane (``dl.cuh`` ``barrier_all``): arrivals at
    rank 0 only, releases at the others only."""
    if n == 1:
        return []
    if me:
        return [Credit(("pad", 0, lane, "barrier")), Wait(("pad", me, lane, "barrier"), 1)]
    return [Wait(("pad", 0, lane, "barrier"), n - 1),
            *[Credit(("pad", r, lane, "barrier")) for r in range(1, n)]]


def a2a_agents(counts, lanes: int, row_units: int, unit: int, order=None, *,
               system_scope: bool = False, stall_rank: int = -1, drop_credit=None,
               wrong_source=None, skip_zero_credit: bool = False) -> list[Agent]:
    """K17's lanes for one team: ``counts[s][d]`` rows source s sends to
    destination d (dispatch: the splits' per-rank totals; combine: their
    transpose), rows of ``row_units`` 16-byte units of ``unit`` elements,
    ``lanes`` a rank.  The planted faults (the walk must catch each):
    ``stall_rank`` credits nothing; ``drop_credit`` (rank, lane, dst) leaves
    out one credit; ``wrong_source`` (rank, lane) waits on source 1 where it
    should wait on source 0; ``skip_zero_credit`` skips the credit of every
    share of zero rows."""
    n = len(counts)
    agents = []
    for me in range(n):
        for lane in range(lanes):
            ops = _hub_barrier(me, n, lane) if system_scope else []
            for p in (order if order is not None else range(n)):
                dst = (me + p) % n
                lo, hi = share(counts[me][dst] * row_units, lanes, lane)
                if hi > lo:
                    ops.append(Copy((me, "x", dst), (dst, "zones", me), lo * unit, hi * unit))
            for dst in range(n):
                lo, hi = share(counts[me][dst] * row_units, lanes, lane)
                if (me == stall_rank or drop_credit == (me, lane, dst)
                        or (skip_zero_credit and hi == lo)):
                    continue
                ops.append(Credit(("pad", dst, lane, "recv", me)))
            for src in range(n):
                waited = 1 if wrong_source == (me, lane) and src == 0 else src
                ops.append(Wait(("pad", me, lane, "recv", waited), 1))
                lo, hi = share(counts[src][me] * row_units, lanes, lane)
                ops.append(Arrived((me, "zones", src), lo * unit, hi * unit))
            agents.append(Agent(me, lane, "lane", ops))
    return agents


def one_shot_agents(n: int, lanes: int, elems: int, quantum: int = 16, *,
                    system_scope: bool = False, stall_rank: int = -1,
                    drop_credit=None) -> list[Agent]:
    """K11's one-shot lanes for one team of n ranks, ``lanes`` a rank, a
    partial of ``elems`` elements cut at ``quantum`` (16 with 16-byte
    units, else 1)."""
    agents = []
    for me in range(n):
        for lane in range(lanes):
            lo, hi = lane_slice(elems, lanes, lane, quantum)
            ops = _hub_barrier(me, n, lane) if system_scope else []
            peers = [(me + off) % n for off in range(1, n)]
            ops += [Copy((me, "x", 0), (p, "slots", me), lo, hi) for p in peers if hi > lo]
            ops += [Credit(("pad", p, lane, "recv", me)) for p in peers
                    if me != stall_rank and drop_credit != (me, lane, p)]
            ops += [Wait(("pad", me, lane, "recv", p), 1) for p in peers]
            ops.append(SlotSum(me, lo, hi))
            agents.append(Agent(me, lane, "lane", ops))
    return agents


def walk_a2a(x: torch.Tensor, counts, offs, z: int, lanes: int, *, order=None, seed: int = 0,
             **kw) -> torch.Tensor:
    """K17's lanes walked on one team's rows ``x`` (n, rows, H): rank s
    sends ``counts[s][d]`` rows from row ``offs[s][d]`` on to destination d.
    Returns the zones (n, n, z, H) by source, NaN past each count."""
    n, _, h = x.shape
    unit = 16 // x.element_size()
    if h % unit:
        raise ValueError(f"rows of {h * x.element_size()} bytes: K17 moves 16-byte units")
    zones = torch.full((n, n, z, h), float("nan")).to(x.dtype)
    bufs = [{"x": [x[r, offs[r][d]:offs[r][d] + counts[r][d]] for d in range(n)],
             "zones": [zones[r, s, :counts[s][r]] for s in range(n)]} for r in range(n)]
    walk(a2a_agents(counts, lanes, h // unit, unit, order, **kw), _LaneState(bufs, n, lanes),
         seed)
    return zones


def walk_one_shot(x: torch.Tensor, lanes: int, out_dtype=None, *, quantum: int = 16,
                  seed: int = 0, **kw) -> torch.Tensor:
    """K11's one-shot lanes walked on one team's partials ``x`` (n, ...):
    returns every rank's copy of the sum (n, ...) in ``out_dtype``."""
    n = x.shape[0]
    elems = x[0].numel()
    out = torch.full(x.shape, float("nan"), dtype=out_dtype or x.dtype)
    bufs = [{"x": [x[r]], "out": [out[r]],
             "slots": list(torch.full((n, *x.shape[1:]), float("nan"), dtype=x.dtype))}
            for r in range(n)]
    walk(one_shot_agents(n, lanes, elems, quantum, **kw), _LaneState(bufs, n, lanes), seed)
    return out


# ---------------------------------------------------------------------------
# K9


def gather_unit(chunk_bytes: int) -> int:
    """The bytes K9 moves a load (``tdt_all_gather``): 16 where the shard's
    bytes allow (the card's bases are 16-byte aligned), else 4, else 1."""
    return 16 if chunk_bytes % 16 == 0 else 4 if chunk_bytes % 4 == 0 else 1


def gather_lanes(chunk_bytes: int, fit: int, system_scope: bool = False) -> int:
    """K9's lanes a rank (``collectives.cu`` ``gather_scoped``): one unit a
    thread at device scope, at least two at system scope, at most ``fit``,
    what the card holds at once split among the ranks."""
    units = chunk_bytes // gather_unit(chunk_bytes)
    per = THREADS * (2 if system_scope else 1)
    return max(1, min(-(-units // per), fit))


def _gather_credit(ops: list, me: int, lane: int, dst: int, chunk: int, stall_rank: int,
                   drop_credit) -> None:
    """Credit ``dst``'s ``recv[chunk]`` in this lane's row, unless the rank
    is stalled or this is the credit ``drop_credit`` (rank, lane, k) names:
    the lane's k-th."""
    k = sum(isinstance(op, Credit) and op.flag[3] == "recv" for op in ops)
    if me != stall_rank and drop_credit != (me, lane, k):
        ops.append(Credit(("pad", dst, lane, "recv", chunk)))


def push_agents(n: int, lanes: int, nbytes: int, unit: int = 16, *,
                system_scope: bool = False, stall_rank: int = -1,
                drop_credit=None) -> list[Agent]:
    """K9's push lanes for one team of n ranks, ``lanes`` a rank, a shard
    of ``nbytes`` bytes cut at ``unit``.  ``stall_rank`` credits nothing;
    ``drop_credit`` (rank, lane, k) leaves out that lane's k-th credit."""
    agents = []
    for me in range(n):
        peers = [(me + off) % n for off in range(1, n)]
        for lane in range(lanes):
            lo, hi = lane_slice(nbytes, lanes, lane, unit)
            put = [Copy((me, "x", 0), (r, "out", me), lo, hi) for r in [me, *peers]
                   if hi > lo]
            if system_scope:   # push_phase: the own chunk, the hub barrier, the peers
                ops = [*put[:1], *_hub_barrier(me, n, lane), *put[1:]]
            else:              # push_each_phase
                ops = put
            for p in peers:
                _gather_credit(ops, me, lane, p, me, stall_rank, drop_credit)
            order = peers if not system_scope else [(me - off) % n for off in range(1, n)]
            ops += [Wait(("pad", me, lane, "recv", p), 1) for p in order]
            ops += [Arrived((me, "out", p), lo, hi) for p in peers]
            agents.append(Agent(me, lane, "lane", ops))
    return agents


def ring_agents(n: int, lanes: int, nbytes: int, unit: int = 16, *, bidir: bool,
                system_scope: bool = False, stall_rank: int = -1,
                drop_credit=None) -> list[Agent]:
    """K9's one-way (``bidir`` False) or two-way ring lanes for one team,
    as :func:`push_agents`."""
    agents = []
    for me in range(n):
        left, right = (me - 1) % n, (me + 1) % n
        for lane in range(lanes):
            lo, hi = lane_slice(nbytes, lanes, lane, unit)
            ops = []

            def send(r, dst, ops=ops, me=me, lane=lane, lo=lo, hi=hi):
                if hi > lo:
                    ops.append(Copy((me, "out", r), (dst, "out", r), lo, hi))
                _gather_credit(ops, me, lane, dst, r, stall_rank, drop_credit)

            def wait(r, ops=ops, me=me, lane=lane):
                ops.append(Wait(("pad", me, lane, "recv", r), 1))

            n_cw, n_ccw = (n // 2, (n - 1) // 2) if bidir else (n - 1, 0)
            firsts = [d for d, k in ((right, n_cw), (left, n_ccw)) if k >= 1]
            if system_scope:   # the own chunk, the neighbours' barrier, then the sends
                if hi > lo:
                    ops.append(Copy((me, "x", 0), (me, "out", me), lo, hi))
                ops += _barrier(me, n, lane)
                for d in firsts:
                    send(me, d)
            else:              # FROM_X: x into the own and the neighbours' chunk at once
                if hi > lo:
                    ops += [Copy((me, "x", 0), (r, "out", me), lo, hi) for r in [me, *firsts]]
                for d in firsts:
                    _gather_credit(ops, me, lane, d, me, stall_rank, drop_credit)
            if not bidir:      # ag_ring_phase: wait, then forward what arrived
                for step in range(n - 1):
                    wait((me - step - 1) % n)
                    if step + 1 < n - 1:
                        send((me - step - 1) % n, right)
            else:              # bidir_ring_phase
                for step in range(max(n_cw, n_ccw)):
                    if step < n_cw:
                        wait((me - step - 1) % n)
                        if step + 1 < n_cw:
                            send((me - step - 1) % n, right)
                    if step < n_ccw:
                        wait((me + step + 1) % n)
                        if step + 1 < n_ccw:
                            send((me + step + 1) % n, left)
            ops += [Arrived((me, "out", p), lo, hi) for p in range(n) if p != me]
            agents.append(Agent(me, lane, "lane", ops))
    return agents


GATHER_FORMS = ("push", "ring", "bidir")


def walk_gather(x: torch.Tensor, lanes: int, form: str = "push", *, seed: int = 0,
                **kw) -> torch.Tensor:
    """K9's lanes of ``form`` (one of :data:`GATHER_FORMS`) walked on one
    team's shards ``x`` (n, m, ...), byte for byte at K9's unit
    (:func:`gather_unit`): returns every rank's gathered copy (n, n m, ...),
    NaN (or its bytes) where nothing landed."""
    if form not in GATHER_FORMS:
        raise ValueError(f"form {form!r}: K9's forms are {GATHER_FORMS}")
    n = x.shape[0]
    xb = x.contiguous().view(torch.uint8).reshape(n, -1)
    nbytes = xb.shape[1]
    out = torch.full((n, n * x.shape[1], *x.shape[2:]), float("nan")).to(x.dtype)
    ob = out.view(torch.uint8).reshape(n, n, nbytes)
    bufs = [{"x": [xb[r]], "out": list(ob[r])} for r in range(n)]
    unit = gather_unit(nbytes)
    agents = (push_agents(n, lanes, nbytes, unit, **kw) if form == "push" else
              ring_agents(n, lanes, nbytes, unit, bidir=form == "bidir", **kw))
    walk(agents, _LaneState(bufs, n, lanes), seed)
    return out
