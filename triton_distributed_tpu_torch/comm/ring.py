"""The ring phases of the collectives, as schedules, and the walk that runs
a schedule on tensors.

Counterpart of ``triton_distributed_tpu/comm/ring.py``.  Each phase appends
one rank's steps to its program (``lang/primitives.py``'s ops): which chunk
goes to which rank's which offset or slot at which step, and which flag
gates it.  The device counterparts are in ``csrc/ring.cuh``, which the
collectives (K9-K11) and the overlapped GEMMs (K12-K14) run; the GEMMs' own
step is a hook of the phase (``consume`` after an AllGather chunk is
forwarded, ``produce`` before a ReduceScatter chunk is read).  :func:`walk`
runs the programs of a team's ranks on tensors, step by step, as the plain
versions.  A chunk is a dim-0 block of ``m`` rows (:func:`chunk`).
"""

from __future__ import annotations

import collections

import torch

from ..lang.primitives import (Matmul, Notify, Put, Reduce, Swiglu, Team, Wait,
                               collective_prologue, notify, put, wait)


def chunk(idx: int, m: int) -> tuple[int, int]:
    """Rows ``[idx * m, (idx + 1) * m)``: dim-0 chunk ``idx``."""
    return idx * m, (idx + 1) * m


def push_phase(prog: list, team: Team, me: int, dst: str) -> None:
    """Full-mesh push (JAX ``_ag_push_kernel`` and ``_ar_one_shot_kernel``):
    this rank's ``x`` into entry ``me`` of ``dst`` on itself, the team
    barrier, then into entry ``me`` of ``dst`` on every peer, each credited
    on the peer's ``recv[me]``; then the n - 1 arrivals, nearest left first."""
    n = team.size
    put(prog, dst, me, me, [("x", 0)])
    collective_prologue(prog, team, me)
    for off in range(1, n):
        put(prog, dst, me, (me + off) % n, [("x", 0)], ("recv", me))
    for off in range(1, n):
        wait(prog, ("recv", (me + n - off) % n))


def ag_ring_phase(prog: list, team: Team, me: int, buf: str = "out",
                  consume=None) -> None:
    """Unidirectional AllGather ring over chunks of ``buf`` already at their
    final offsets (chunk ``me`` holds this rank's part): each of the n - 1
    steps forwards the chunk received last step (step 0: one's own) to the
    right neighbour and waits for the incoming one (JAX ``ag_ring_phase``;
    its send drain ``ag_ring_drain`` has no counterpart here).  With
    ``consume`` (AG-GEMM, ``ag_gemm.py:97-117``), ``consume(r)`` appends the
    use of chunk r right after it is forwarded: one's own first, then each
    arrival in turn."""
    n = team.size
    _, right = team.neighbor_ranks(me)
    for step in range(n - 1):
        c_send = (me + n - step) % n
        put(prog, buf, c_send, right, [(buf, c_send)], ("recv", c_send))
        if consume is not None:
            consume(c_send)
        wait(prog, ("recv", (me + n - step - 1) % n))
    if consume is not None:
        consume((me + 1) % n)


def bidir_ring_phase(prog: list, team: Team, me: int, buf: str = "out",
                     consume=None) -> None:
    """Bidirectional AllGather ring over chunks of ``buf`` at their final
    offsets: ceil((n-1)/2) chunks travel clockwise, floor((n-1)/2)
    counter-clockwise; each is forwarded right after its arrival (JAX
    ``bidir_ring_phase``), then consumed when ``consume`` is given (one's
    own chunk after its two sends: the arrival order me, me - 1, me + 1,
    me - 2, ...)."""
    n = team.size
    left, right = team.neighbor_ranks(me)
    n_cw, n_ccw = n // 2, (n - 1) // 2
    if n_cw >= 1:
        put(prog, buf, me, right, [(buf, me)], ("recv", me))
    if n_ccw >= 1:
        put(prog, buf, me, left, [(buf, me)], ("recv", me))
    if consume is not None:
        consume(me)
    for step in range(max(n_cw, n_ccw)):
        if step < n_cw:
            r = (me + n - step - 1) % n
            wait(prog, ("recv", r))
            if step + 1 < n_cw:
                put(prog, buf, r, right, [(buf, r)], ("recv", r))
            if consume is not None:
                consume(r)
        if step < n_ccw:
            r = (me + step + 1) % n
            wait(prog, ("recv", r))
            if step + 1 < n_ccw:
                put(prog, buf, r, left, [(buf, r)], ("recv", r))
            if consume is not None:
                consume(r)


def rs_ring_phase(prog: list, team: Team, me: int, last_dst: tuple[str, int],
                  last_f32: bool, local: str = "x", produce=None) -> None:
    """The ReduceScatter ring (JAX ``reduce_scatter.py:75-110``): chunk j's
    partial sum starts at rank j + 1 and travels right through the two
    receive slots of each rank, every hop adding the local chunk (entry j of
    ``local``); the last hop (at rank j itself) lands in ``last_dst``, in
    the input dtype or, with ``last_f32``, as an f32 sum rounded to the
    output dtype (two-shot AllReduce).  Each hop's add is fused into its put,
    in JAX's order and rounding (received partial + local chunk).  A slot is
    reused only after the right neighbour's ACK credit for it; pair with
    :func:`rs_ack_drain`.  With ``produce`` (GEMM-RS, ``gemm_rs.py:89-123``),
    ``produce(j)`` appends the making of local chunk j before the step that
    reads it: the chunk that travels farthest first, and each later one
    before its arrival wait, so the product hides the hop in flight."""
    n = team.size
    left, right = team.neighbor_ranks(me)
    j0 = (me + n - 1) % n
    if produce is not None:
        produce(j0)
    put(prog, "recv", 0, right, [(local, j0)], ("rs_recv", 0))
    for s in range(1, n):
        j = (me + n - s - 1) % n
        slot_in = (s - 1) % 2
        if produce is not None:
            produce(j)
        wait(prog, ("rs_recv", slot_in))
        if s == n - 1:
            prog.append(Reduce(last_dst, (("recv", slot_in), (local, j)), last_f32))
        else:
            slot_out = s % 2
            if s >= 2:
                wait(prog, ("ack", slot_out))
            put(prog, "recv", slot_out, right, [("recv", slot_in), (local, j)],
                ("rs_recv", slot_out))
        notify(prog, ("ack", slot_in), left)


def chunk_ar_phase(prog: list, team: Team, me: int, src: tuple[str, int], dst: str,
                   armed: bool) -> None:
    """One column-chunked GEMM + two-shot AllReduce instance (JAX
    ``comm/ring.py::gemm_rs_chunk_phase`` then ``ag_ring_phase``, as
    ``fused_decode.py:507-580`` and ``persistent_decode.py:206-252``
    ``_chained_ar`` run them): the ReduceScatter ring of
    :func:`rs_ring_phase` whose chunk j is the product of the activations
    ``src`` with weight column chunk ("w", j), made just before the step
    that reads it, its last add landing in chunk ``me`` of ``dst``; then the
    AllGather ring of the reduced chunks of ``dst``.  ``armed`` (an
    instance after the first on the same flags) first takes the previous
    instance's outstanding ACK credits (:func:`rs_ack_drain`); an instance
    drains none at its own end."""
    if armed:
        rs_ack_drain(prog, team.size)
    rs_ring_phase(prog, team, me, (dst, me), last_f32=False, local="mm",
                  produce=lambda j: prog.append(Matmul(("mm", j), src, ("w", j))))
    ag_ring_phase(prog, team, me, dst)


def a2a_push_phase(prog: list, team: Team, me: int, send, expected, chunk_rows: int,
                   order=None) -> None:
    """The EP all-to-all's push (JAX ``all_to_all.py::_a2a_push_kernel``):
    the hub barrier, then for each peer offset p of ``order`` (default
    0..n-1; JAX ``AllToAllConfig.schedule``) the ``send[dst]`` rows for
    dst = me + p in puts of ``chunk_rows``, put c landing in chunk c of
    zone ``me`` on dst (entry ("zones", (me, c)); its source is entry
    ("x", (dst, c))), each credited on dst's ``recv[me]`` (one's own zone
    too: JAX counts that copy as well); then, for each source p in order,
    one wait on ``recv[p]`` per chunk of the ``expected[p]`` rows it sends.
    Dispatch and combine run it with the roles of ``send`` and
    ``expected`` swapped."""
    n = team.size
    collective_prologue(prog, team, me)
    for p in (order if order is not None else range(n)):
        dst = (me + p) % n
        for c in range(-(-send[dst] // chunk_rows)):
            put(prog, "zones", (me, c), dst, [("x", (dst, c))], ("recv", me))
    for p in range(n):
        for _ in range(-(-expected[p] // chunk_rows)):
            wait(prog, ("recv", p))


def rs_ack_drain(prog: list, n: int) -> None:
    """Take the ACK credits still outstanding at the end of the ring: the
    in-loop waits covered sends 0..n-4; the last two sends' credits (one
    when n == 2) arrive after the loop.  Every flag is then back at zero."""
    if n == 2:
        wait(prog, ("ack", 0))
    else:
        wait(prog, ("ack", (n - 3) % 2))
        wait(prog, ("ack", (n - 2) % 2))


# ---------------------------------------------------------------------------
# the plain versions' executor


def _apply(op, r: int, bufs: list[dict]) -> None:
    if isinstance(op, Matmul):
        # the f32 product of the operands, rounded once by the copy
        a, b = bufs[r][op.src[0]][op.src[1]], bufs[r][op.w[0]][op.w[1]]
        bufs[r][op.dst[0]][op.dst[1]].copy_(torch.matmul(a.float(), b.float()))
        return
    if isinstance(op, Swiglu):
        g, u = (bufs[r][name][i].float() for name, i in (op.g, op.u))
        bufs[r][op.dst[0]][op.dst[1]].copy_(torch.nn.functional.silu(g) * u)
        return
    src = [bufs[r][b][i] for b, i in op.srcs]
    if isinstance(op, Put):
        bufs[op.dst_rank][op.dst][op.index].copy_(
            src[0] if len(src) == 1 else src[0] + src[1])
    elif op.f32:
        acc = src[0].float()
        for t in src[1:]:
            acc = acc + t.float()
        bufs[r][op.dst[0]][op.dst[1]].copy_(acc)
    else:
        bufs[r][op.dst[0]][op.dst[1]].copy_(src[0] + src[1])


def _reads(op) -> tuple:
    """The (buffer, index) entries an op reads."""
    if isinstance(op, Matmul):
        return (op.src, op.w)
    if isinstance(op, Swiglu):
        return (op.g, op.u)
    return op.srcs


def walk(programs: list[list], bufs: list[dict[str, list[torch.Tensor]]] | None,
         unread: tuple[str, ...] = ()) -> None:
    """Run the programs of one team's ranks on tensors: ``bufs[r][name][i]``
    is entry ``i`` (a chunk or a slot; a list index or a dict key) of rank
    ``r``'s buffer ``name``
    (``bufs[r]["b"][0]``: the rank's B operand of a :class:`Matmul`).
    ``bufs`` None walks the protocol alone: credits and waits, no data.

    Each rank runs until a :class:`Wait` finds its flag short, then the next
    rank runs; a round in which no rank moves is a deadlock and raises, as
    does a flag left non-zero at the end (every credit must be taken).

    ``unread``: landing buffers whose entries must be read (by a Reduce, a
    Put or a compute) between two puts into them; a put onto an entry still
    unread raises, which is how a landing that should be double-buffered is
    caught with one buffer."""
    n = len(programs)
    pcs = [0] * n
    flags: collections.Counter = collections.Counter()
    full: set = set()
    while any(pc < len(p) for pc, p in zip(pcs, programs)):
        moved = False
        for r, prog in enumerate(programs):
            while pcs[r] < len(prog):
                op = prog[pcs[r]]
                if isinstance(op, Wait):
                    if flags[r, op.flag] < op.count:
                        break
                    flags[r, op.flag] -= op.count
                elif isinstance(op, Notify):
                    flags[op.target, op.flag] += 1
                else:
                    if unread:
                        full.difference_update((r, b, i) for b, i in _reads(op))
                        if isinstance(op, Put) and op.dst in unread:
                            key = (op.dst_rank, op.dst, op.index)
                            if key in full:
                                raise RuntimeError(
                                    f"schedule overwrites {op.dst}[{op.index}] of rank "
                                    f"{op.dst_rank} before it was read (rank {r}: {op})")
                            full.add(key)
                    if bufs is not None:
                        _apply(op, r, bufs)
                    if isinstance(op, Put) and op.flag is not None:
                        flags[op.dst_rank, op.flag] += 1
                pcs[r] += 1
                moved = True
        if not moved:
            stuck = {r: programs[r][pc] for r, pc in enumerate(pcs) if pc < len(programs[r])}
            raise RuntimeError(f"schedule deadlock: {stuck}")
    left = {k: v for k, v in flags.items() if v}
    if left:
        raise RuntimeError(f"schedule leaves flags non-zero: {left}")
