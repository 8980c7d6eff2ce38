"""K17's and K11's one-shot lanes on the card, as a walk.

The rank-level schedules (``comm/ring.py``: ``a2a_push_phase``, ``push_phase``)
say what goes where; the plain versions walk them.  On the card a rank is
many lanes (blocks), and since their redesign ``csrc/all_to_all.cu`` and
``csrc/ring.cuh::one_shot_phase`` credit and wait lane by lane in a way
those schedules do not show.  This module mirrors that protocol, and
:func:`comm.tiles.walk` runs it on tensors under a seeded random
interleaving of the lanes, checking that no lane reads (K11) or is told
of (K17) a share that has not arrived, that no lane blocks forever, and that
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

The system-scope forms (the multi-card host) add JAX's hub barrier first,
lane by lane.  Shares are in 16-byte units (K17: ``unit`` elements of a row
of a multiple of 16 bytes), slices are ``dl.cuh``'s ``Rank::slice``
(:func:`comm.tiles.lane_slice`).  The lanes are a parameter: on the card
K17 takes as many as the card holds at once, capped by a full zone at four
16-byte vectors a thread, and K11's one-shot one 16-byte unit a thread.
"""

from __future__ import annotations

import dataclasses

import torch

from .tiles import (Agent, Copy, Credit, ProtocolError, Wait, _covered, _State, lane_slice,
                    walk)


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
