"""Event pool: structure-of-arrays encoding of the simulation events
(counterpart of ``repro.core.events``).

Every pool and batch carries a leading agent dimension ``A``: pool fields are
(A, cap) (payload (A, cap, PAYLOAD)), the free-ring cursors are (A,). The one
exception is the builder's initial event batch, which is unstacked (n,).
Timestamps are int32 ticks; dead slots carry ``T_INF``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import registry as _registry
from repro_torch.core import tensor_util as tu

T_INF = 2**31 - 1
PAYLOAD = _registry.PAYLOAD
MAX_EMIT = 4
SEQ_MASK = 2**31 - 1

I32 = torch.int32


def child_seq(parent_seq: torch.Tensor, slot: int) -> torch.Tensor:
    """Functional tie-break id: the int32 multiply wraps two's-complement and
    the sign bit is masked, exactly as in the reference and its oracle."""
    return (parent_seq.to(I32) * MAX_EMIT + (slot + 1)) & SEQ_MASK


class EventPool(NamedTuple):
    """Per-agent pending-event store with its free-slot ring.

    Ring positions ``head .. head+count-1 (mod cap)`` hold exactly the free
    slots; ``insert`` pops off the head, ``release`` pushes onto the tail."""

    time: torch.Tensor       # i32 (A, cap)
    seq: torch.Tensor        # i32 (A, cap)
    kind: torch.Tensor       # i32 (A, cap)
    src: torch.Tensor        # i32 (A, cap)
    dst: torch.Tensor        # i32 (A, cap)
    ctx: torch.Tensor        # i32 (A, cap)
    payload: torch.Tensor    # f32 (A, cap, PAYLOAD)
    valid: torch.Tensor      # bool (A, cap)
    free_ring: torch.Tensor  # i32 (A, cap)
    free_head: torch.Tensor  # i32 (A,)
    free_tail: torch.Tensor  # i32 (A,)
    free_count: torch.Tensor  # i32 (A,)

    @property
    def cap(self) -> int:
        return self.time.shape[-1]


def empty_pool(cap: int, n_agents: int = 1, device="cpu") -> EventPool:
    shape = (n_agents, cap)

    def full(v):
        return torch.full(shape, v, dtype=I32, device=device)

    return EventPool(
        time=full(T_INF), seq=full(0), kind=full(0), src=full(0),
        dst=full(0), ctx=full(0),
        payload=torch.zeros(shape + (PAYLOAD,), dtype=torch.float32,
                            device=device),
        valid=torch.zeros(shape, dtype=torch.bool, device=device),
        free_ring=tu.arange(cap, device).repeat(n_agents, 1),
        free_head=torch.zeros((n_agents,), dtype=I32, device=device),
        free_tail=torch.zeros((n_agents,), dtype=I32, device=device),
        free_count=torch.full((n_agents,), cap, dtype=I32, device=device),
    )


def occupancy(pool: EventPool) -> torch.Tensor:
    """Live slots per agent, O(1) off the ring's free count."""
    return pool.cap - pool.free_count


class EventBatch(NamedTuple):
    """A dense batch of candidate events (pool fields plus a mask)."""

    time: torch.Tensor
    seq: torch.Tensor
    kind: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor
    ctx: torch.Tensor
    payload: torch.Tensor
    valid: torch.Tensor

    @property
    def size(self) -> int:
        return self.time.shape[-1]

    def map(self, fn) -> "EventBatch":
        return EventBatch(*(fn(x) for x in self))


def empty_batch(shape, device="cpu") -> EventBatch:
    shape = (shape,) if isinstance(shape, int) else tuple(shape)

    def full(v):
        return torch.full(shape, v, dtype=I32, device=device)

    return EventBatch(
        time=full(T_INF), seq=full(0), kind=full(0), src=full(0),
        dst=full(0), ctx=full(0),
        payload=torch.zeros(shape + (PAYLOAD,), dtype=torch.float32,
                            device=device),
        valid=torch.zeros(shape, dtype=torch.bool, device=device))


def batch_from_rows(rows) -> EventBatch:
    """Stack a list of event dicts into an unstacked (n,) batch (host side)."""
    n = len(rows)
    if n == 0:
        return empty_batch(1)

    def col(name):
        return torch.tensor([int(r.get(name, 0)) for r in rows], dtype=I32)

    payload = torch.zeros((n, PAYLOAD), dtype=torch.float32)
    for i, r in enumerate(rows):
        pl = torch.as_tensor(r.get("payload", ()), dtype=torch.float32)
        payload[i, : pl.shape[0]] = pl
    return EventBatch(time=col("time"), seq=col("seq"), kind=col("kind"),
                      src=col("src"), dst=col("dst"), ctx=col("ctx"),
                      payload=payload,
                      valid=torch.ones((n,), dtype=torch.bool))


def _scatter_batch(pool: EventPool, batch: EventBatch, idx: torch.Tensor,
                   fits: torch.Tensor) -> EventPool:
    """Write the fitting batch rows into pool slots ``idx`` (cap == dropped)."""
    new = tu.scatter_rows_many([getattr(pool, f) for f in EventBatch._fields],
                               idx, list(batch._replace(valid=fits)))
    return pool._replace(**dict(zip(EventBatch._fields, new)))


def rebuild_ring(pool: EventPool) -> EventPool:
    """Canonicalize the free ring from ``valid`` (O(cap), whole-pool paths):
    free slots first in ascending order with ``head == 0``, live slots after
    them, also ascending."""
    ring = torch.sort(pool.valid.to(torch.uint8), dim=1,
                      stable=True).indices.to(I32)
    n_free = tu.isum(~pool.valid, 1)
    return pool._replace(free_ring=ring, free_head=torch.zeros_like(n_free),
                         free_tail=n_free % pool.cap, free_count=n_free)


def insert(pool: EventPool, batch: EventBatch, slot_fn=None):
    """Insert ``batch`` (A, n) (masked rows skipped) into free pool slots.

    The r-th fitting row of agent ``a`` takes the slot at ring position
    ``(free_head[a] + r) % cap``. ``slot_fn(free_ring, free_head, want)``
    computes those slots for every wanted row (the ``ring_slots`` kernel);
    the default is the gather below. Returns (pool', n_dropped (A,))."""
    cap = pool.cap
    want = batch.valid
    want_rank = tu.icumsum(want, 1) - 1
    n_want = tu.isum(want, 1)
    fits = want & (want_rank < pool.free_count[:, None])
    n_take = tu.isum(fits, 1)
    if slot_fn is None:
        pos = (pool.free_head[:, None] + want_rank.clamp_min(0)) % cap
        dst_slot = torch.gather(pool.free_ring, 1, pos.long())
    else:
        dst_slot = slot_fn(pool.free_ring, pool.free_head, want)
    idx = torch.where(fits, dst_slot, cap)
    pool = _scatter_batch(pool, batch, idx, fits)
    return pool._replace(
        free_head=(pool.free_head + n_take) % cap,
        free_count=pool.free_count - n_take,
    ), n_want - n_take


def insert_ref(pool: EventPool, batch: EventBatch):
    """Reference insert (``insert_mode="ref"``): the r-th fitting row takes
    the r-th free slot in ascending slot order, found by an O(cap) rank scan
    of ``valid``. Keeps the same rows as :func:`insert`; only the slot layout
    differs. Only ``free_count`` is kept exact: the ring and its cursors go
    stale, as nothing in ref mode reads them. Returns (pool', n_dropped)."""
    A, cap = pool.valid.shape
    free = ~pool.valid
    free_rank = tu.icumsum(free, 1) - 1
    n_free = tu.isum(free, 1)
    want = batch.valid
    want_rank = tu.icumsum(want, 1) - 1
    n_want = tu.isum(want, 1)
    fits = want & (want_rank < n_free[:, None])
    n_drop = n_want - tu.isum(fits, 1)
    # rank -> slot: every live slot writes 0 at rank cap - 1, which no free
    # slot holds unless the pool is empty (then no live slot writes there)
    slots = tu.arange(cap, pool.valid.device)[None].expand(A, cap)
    rank_to_slot = torch.zeros((A, cap), dtype=I32,
                               device=pool.valid.device).scatter(
        1, torch.where(free, free_rank, cap - 1).long(),
        torch.where(free, slots, 0))
    dst_slot = torch.gather(rank_to_slot, 1,
                            want_rank.clamp(0, cap - 1).long())
    idx = torch.where(fits, dst_slot, cap)
    pool = _scatter_batch(pool, batch, idx, fits)
    return pool._replace(free_count=pool.free_count - (n_want - n_drop)), \
        n_drop


def release(pool: EventPool, slots: torch.Tensor, mask: torch.Tensor,
            pos: torch.Tensor | None = None) -> EventPool:
    """Reclaim executed slots: invalidate and push onto the ring's tail.

    ``slots`` (A, m) are distinct slot indices, ``mask`` flags the rows that
    executed; the r-th masked slot lands at ring position
    ``(free_tail + r) % cap``. ``pos`` supplies those positions when they
    were computed already (the fused front end's ``rel_pos``); it must equal
    them on every masked row."""
    cap = pool.cap
    n = tu.isum(mask, 1)
    if pos is None:
        rank = tu.icumsum(mask, 1) - 1
        pos = (pool.free_tail[:, None] + rank.clamp_min(0)) % cap
    ring = tu.scatter_rows(pool.free_ring, torch.where(mask, pos, cap),
                           slots.to(I32))
    gone = torch.where(mask, slots, cap)
    time, valid = tu.scatter_rows_many([pool.time, pool.valid], gone,
                                       [T_INF, False])
    return pool._replace(
        time=time,
        valid=valid,
        free_ring=ring,
        free_tail=(pool.free_tail + n) % cap,
        free_count=pool.free_count + n,
    )


def extract(pool: EventPool, mask: torch.Tensor) -> EventBatch:
    """Pool rows as a routable batch, valid where live and masked (slot
    order)."""
    return EventBatch(*(getattr(pool, f) for f in EventBatch._fields[:-1]),
                      valid=pool.valid & mask)


def pop_mask(pool: EventPool, mask: torch.Tensor) -> EventPool:
    """Invalidate the masked slots and canonicalize the free ring."""
    gone = pool.valid & mask
    pool = pool._replace(time=torch.where(gone, T_INF, pool.time),
                         valid=pool.valid & ~mask)
    return rebuild_ring(pool)


def pop_mask_ref(pool: EventPool, mask: torch.Tensor) -> EventPool:
    """Invalidate the masked slots, keeping only ``free_count`` exact (the
    ``insert_mode="ref"`` reclaim)."""
    gone = pool.valid & mask
    return pool._replace(time=torch.where(gone, T_INF, pool.time),
                         valid=pool.valid & ~mask,
                         free_count=pool.free_count + tu.isum(gone, 1))


def gather(pool: EventPool, idx: torch.Tensor) -> EventBatch:
    """Gather pool slots ``idx`` (A, m) into a dense candidate batch (also
    reorders a batch: any tuple with the batch's fields)."""
    a = torch.arange(idx.shape[0], device=idx.device)[:, None]
    i = idx.clamp(0, pool.time.shape[1] - 1).long()
    return EventBatch(*(getattr(pool, f)[a, i] for f in EventBatch._fields))


def compact_batch(batch: EventBatch, cap: int):
    """Compact each agent's valid rows, in order, into a ``cap``-row batch.

    One stable sort on the valid flag plus a ``cap``-row gather; rows beyond
    ``cap`` are dropped and counted. Returns (batch', n_valid, n_dropped),
    the counts per agent."""
    A, n = batch.valid.shape
    take = min(cap, n)
    order = torch.sort((~batch.valid).to(torch.uint8), dim=1,
                       stable=True).indices[:, :take]
    out = gather(batch, order)
    if take < cap:
        pad = empty_batch((A, cap - take), device=batch.time.device)
        out = EventBatch(*(torch.cat([a, b], 1) for a, b in zip(out, pad)))
    out = out._replace(time=torch.where(out.valid, out.time, T_INF))
    n_valid = tu.isum(batch.valid, 1)
    n_kept = tu.isum(out.valid, 1)
    return out, n_valid, n_valid - n_kept


def trace_append(trace: torch.Tensor, trace_n: torch.Tensor,
                 rows4: torch.Tensor, mask: torch.Tensor, *,
                 ring: bool = False, rank_fn=None):
    """Append a window's processed rows (A, n, 4) to the (A, cap, 4) trace.

    The r-th masked row lands at position ``trace_n + r``; ``rank_fn`` is
    the hook computing that exclusive prefix rank (the ``trace_rank``
    kernel), the default an int32 cumsum. Bounded mode clips positions past
    ``cap`` and returns their number; ring mode wraps. Returns
    ``(trace, trace_n', n_clipped)``."""
    cap = trace.shape[1]
    n = mask.shape[1]
    w = mask.to(I32)
    rank = (tu.icumsum(w, 1) - w) if rank_fn is None else rank_fn(mask)
    tpos = trace_n[:, None] + rank
    if ring:
        tidx = torch.where(mask, tpos % cap, n + cap)
        clipped = torch.zeros_like(trace_n)
    else:
        tidx = torch.where(mask & (tpos < cap), tpos, n + cap)
        clipped = tu.isum(mask & (tpos >= cap), 1)
    trace = tu.scatter_rows(trace, tidx, rows4)
    return trace, trace_n + tu.isum(w, 1), clipped


def min_pending_time_per_ctx(pool: EventPool, n_ctx: int) -> torch.Tensor:
    """(A, n_ctx) minimum pending timestamp per simulation context."""
    A = pool.time.shape[0]
    t = torch.where(pool.valid, pool.time, T_INF)
    seg = torch.where(pool.valid, pool.ctx, 0)
    seg = torch.where((seg >= 0) & (seg < n_ctx), seg, n_ctx)
    init = torch.full((A, n_ctx + 1), T_INF, dtype=I32,
                      device=pool.time.device)
    out = init.scatter_reduce(1, seg.long(), t, "amin", include_self=True)
    return out[:, :n_ctx]
