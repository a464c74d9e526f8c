"""Plain PyTorch versions of the Hopper kernels.

Counterparts of ``repro.kernels.ref`` and of the XLA twins in
``repro.core.engine`` (``select_events_xla``, ``group_by_kind_xla``,
``route_rank_xla``), plus the free-ring ``ring_slots``, the fused window
front end ``fused_select`` and the max-min water-fill ``maxmin_rates`` (the
reference's ``core.network.maxmin_rates``). The front-end functions work
row-wise over a leading agent dimension, inputs (A, n); ``maxmin_rates``
over a leading lane dimension. The model zoo's kernels have
theirs too: ``attention`` (``repro.kernels.ref.attention_ref``, the function
of the Pallas ``flash_attention``) and ``gla_scan`` (the chunked math of the
Pallas ``gla_pallas`` in both modes). These serve CPU tensors and are what
``chip_smoke.py`` holds the CUDA kernels against on the card.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

I32 = torch.int32


class FusedSelect(NamedTuple):
    """The window front end's result, every field window-aligned over the
    ``m = max(min(exec_cap, cap), 1)`` lanes of each agent: the selected
    slots in (time, seq) order and their safe flags, their gathered fields
    (raw on lanes that are not safe), the conflict-free lanes, the
    same-kind grouping permutation of the clean lanes and each lane's
    free-ring release position (meaningful on safe lanes)."""

    exec_idx: torch.Tensor   # (A, m) i32 pool slots
    exec_safe: torch.Tensor  # (A, m) bool
    time: torch.Tensor       # (A, m) i32 gathered event fields ...
    seq: torch.Tensor
    kind: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor
    ctx: torch.Tensor
    payload: torch.Tensor    # (A, m, PAYLOAD) f32
    valid: torch.Tensor      # (A, m) bool
    clean: torch.Tensor      # (A, m) bool: safe and conflict-free
    order: torch.Tensor      # (A, m) i32 grouping permutation
    rel_pos: torch.Tensor    # (A, m) i32 free-ring release position


def _argsort(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, dim=-1, stable=True).indices


def sort_events(time_key: torch.Tensor, seq: torch.Tensor) -> torch.Tensor:
    """(A, cap) -> (A, cap) permutation ascending by (time, seq), ties by
    slot index (two stable sorts, as ``lexsort_time_seq``)."""
    perm = _argsort(seq)
    perm2 = _argsort(torch.gather(time_key, -1, perm))
    return torch.gather(perm, -1, perm2).to(I32)


def select_events(time_key: torch.Tensor, seq: torch.Tensor,
                  exec_cap: int) -> torch.Tensor:
    """First ``min(exec_cap, cap)`` indices of the (time, seq) sort."""
    return sort_events(time_key, seq)[:, : min(exec_cap, time_key.shape[-1])]


def group_by_kind(kind: torch.Tensor, active: torch.Tensor, n_kinds: int):
    """Same-kind grouping ``(order, rank, counts)``: active rows first by
    ascending kind (clipped into range), stable in position, inactive rows
    last; ``rank`` aligned with ``order``; ``counts`` (A, n_kinds)."""
    key = torch.where(active.bool(), kind.clamp(0, n_kinds - 1), n_kinds)
    order = _argsort(key)
    ks = torch.gather(key, -1, order).contiguous()
    start = torch.searchsorted(ks, ks, side="left").to(I32)
    rank = torch.arange(ks.shape[-1], dtype=I32, device=ks.device) - start
    counts = torch.zeros(key.shape[:-1] + (n_kinds + 1,), dtype=I32,
                         device=key.device)
    counts = counts.scatter_add(-1, key.long(), torch.ones_like(key))
    return order.to(I32), rank, counts[..., :n_kinds]


def trace_rank(mask: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix count of the mask along the last dimension."""
    w = mask.to(I32)
    return torch.cumsum(w, dim=-1, dtype=I32) - w


def route_rank(dst_agent: torch.Tensor) -> torch.Tensor:
    """Stable within-bucket ranks for any int keys:
    ``rank[i] = |{j < i : dst_agent[j] == dst_agent[i]}|``."""
    sperm = _argsort(dst_agent)
    skey = torch.gather(dst_agent, -1, sperm).contiguous()
    group_start = torch.searchsorted(skey, skey, side="left").to(I32)
    rank_sorted = (torch.arange(skey.shape[-1], dtype=I32,
                                device=skey.device) - group_start)
    return torch.zeros_like(rank_sorted).scatter(-1, sperm, rank_sorted)


def ring_slots(free_ring: torch.Tensor, head: torch.Tensor,
               want: torch.Tensor) -> torch.Tensor:
    """Free-ring insert slots: ``free_ring[a, (head[a] + rank) % cap]`` with
    ``rank`` the exclusive prefix count of ``want`` (A, n)."""
    cap = free_ring.shape[-1]
    pos = (head.to(I32)[:, None] + trace_rank(want)) % cap
    return torch.gather(free_ring, -1, pos.long())


def fused_select(time_key, seq, safe, time, kind, src, dst, ctx, payload,
                 valid, table_id, res, free_tail, exec_cap: int, *,
                 n_kinds: int, n_res: int
                 ) -> tuple[FusedSelect, torch.Tensor]:
    """The window front end over (A, cap) pools: select the
    ``m = max(min(exec_cap, cap), 1)`` earliest slots, gather their fields,
    mark conflicts by a pairwise count on ``rkey = table_id * n_res + res``
    (rows with ``table_id == 0`` never conflict), group the clean lanes by
    kind, and rank the free-ring release ``(free_tail + rank) % cap``.
    Composed as ``repro.kernels.ref.fused_select_ref``. Returns the
    ``FusedSelect`` and the clean lanes' per-kind counts (A, n_kinds), as
    ``group_by_kind`` returns them."""
    cap = time_key.shape[-1]
    m = max(min(exec_cap, cap), 1)
    idx = select_events(time_key, seq, m)
    ix = idx.long()

    def g(x):
        return torch.gather(x, 1, ix)

    es = g(safe)
    tb = g(table_id)
    rkey = tb * n_res + g(res)
    comp = es & (tb > 0)
    cnt = ((rkey[:, :, None] == rkey[:, None, :])
           & comp[:, None, :]).sum(2)
    clean = es & ~(comp & (cnt >= 2))
    kind_w = g(kind)
    order, _rank, counts = group_by_kind(kind_w, clean, n_kinds)
    rel = (free_tail.to(I32)[:, None] + trace_rank(es)) % cap
    pay = torch.gather(payload, 1,
                       ix[..., None].expand(-1, -1, payload.shape[-1]))
    return FusedSelect(
        exec_idx=idx, exec_safe=es, time=g(time), seq=g(seq), kind=kind_w,
        src=g(src), dst=g(dst), ctx=g(ctx), payload=pay, valid=g(valid),
        clean=clean, order=order, rel_pos=rel), counts


# ------------------------------------------------------------------ max-min
_EPS = 1e-6
_BIG = 3.0e38

class FlowOrder(NamedTuple):
    """An order of the sum over F flows. The first ``head`` flows go to eight
    lane accumulators, lane l taking flows 8 * b + l for the 8-flow blocks b
    of ``blocks``: split into ``chains`` equal runs, each run summed in turn
    and the runs added one after another. The lanes are then added by
    halves ((l, l + 4), then (l, l + 2), then (0, 1)). The flows from
    ``head`` on are summed in ``tail_lanes`` interleaved sums, lane k taking
    flows head + k, head + k + tail_lanes, ..., lane 0 starting from the
    head's total, and those lanes are added by halves. The last
    ``trailing`` flows stay out of the tail lanes: they are added to that
    total one at a time, in order. The default is left to right."""

    head: int = 0
    blocks: tuple = ()
    chains: int = 1
    tail_lanes: int = 1
    trailing: int = 0


LEFT_TO_RIGHT = FlowOrder()

# XLA:CPU's order for an unbatched ``inc.T @ x`` over F flows and L links,
# read off its compiled matvec (jax 0.9.0) by tools/probe_flow_order.py at
# every F = 2-256 and L = 1-128 (F = 43-128 at L = 1-64 by the unpacked
# probe; the rest by the packed one), and past that at every F = 257-512
# at L = 1-9, 64, 65, 128, 129 and 256, every F = 2-256 at L = 129 and
# 256 (F >= 43 also at 130, 192 and 255), and seeded samples of the other
# L up to 256. ``_UNBATCHED_ORDER[F]`` lists (first L, last L, order).
# Every tree probed has the FlowOrder form: a head of 32, 48 or 64 flows,
# or a multiple of 32 up to 512, in one of the block orders below, then 1,
# 2, 4 or 8 tail lanes and up to 8 trailing flows; the gaps between the
# ranges sum left to right. The probe found left to right at every F <=
# 42. From F = 129 on the orders repeat every 32 flows: F = H + r (H = 32
# * (F // 32)) takes the ranges of F = 96 + r with a head of H flows where
# F = 96 + r has 96 (H - 32 where it has 64), its blocks in four runs from
# L = 9 on (and at L = 1-8 past ``_ONE_CHAIN_HEAD``). At every F, L =
# 65-256 takes the order of L = 64 (``_carry``). F > 512 and L > 256 are
# not probed, and the port sums them left to right (ROADMAP.md, section
# 3).
def _head(n_flows: int, chains: int = 1) -> FlowOrder:
    """A head of ``n_flows`` (a multiple of 32) in XLA:CPU's block order:
    the blocks in four runs by residue mod 4, (0, 4, 8, ...), (1, 5, 9,
    ...), (2, 6, ...), (3, 7, ...); in one chain the first two blocks of
    each run after the first swap places."""
    m = n_flows // 32
    runs = [[r + 4 * i for i in range(m)] for r in range(4)]
    if chains == 1:
        for run in runs[1:]:
            run[0], run[1] = run[1], run[0]
    return FlowOrder(n_flows, tuple(b for run in runs for b in run), chains)


_ORDER_48 = FlowOrder(48, (0, 2, 4, 3, 1, 5))
_ORDER_64 = _head(64)
_ORDER_96 = _head(96)
_ORDER_128 = _head(128)
_ORDER_128_CHAINS = _head(128, chains=4)
_ORDER_32 = FlowOrder(32, (0, 1, 2, 3))
# F: ((first L, last L, head, tail lanes, trailing flows), ...)
_UNBATCHED_ORDER = {F: tuple((lo, hi, head._replace(tail_lanes=W, trailing=T))
                             for lo, hi, head, W, T in rows)
                    for F, rows in {
    43: ((1, 1, _ORDER_32, 4, 3),),
    44: ((1, 1, _ORDER_32, 4, 0),),
    45: ((1, 1, _ORDER_32, 4, 1),),
    46: ((1, 1, _ORDER_32, 4, 2),),
    47: ((1, 1, _ORDER_32, 4, 3),),
    48: ((1, 1, _ORDER_48, 1, 0),),
    49: ((1, 1, _ORDER_48, 1, 0),),
    50: ((1, 1, _ORDER_48, 1, 0), (3, 64, _ORDER_48, 1, 0)),
    51: ((1, 1, _ORDER_48, 1, 0), (3, 64, _ORDER_48, 1, 0)),
    52: ((1, 1, _ORDER_48, 2, 0), (3, 8, _ORDER_48, 1, 0),
         (9, 64, _ORDER_48, 2, 0)),
    53: ((1, 1, _ORDER_48, 2, 1), (3, 64, _ORDER_48, 2, 1)),
    54: ((1, 1, _ORDER_48, 2, 2), (3, 64, _ORDER_48, 2, 2)),
    55: ((1, 1, _ORDER_48, 2, 3), (3, 8, _ORDER_48, 2, 1),
         (9, 64, _ORDER_48, 2, 3)),
    56: ((1, 1, _ORDER_48, 4, 0), (3, 8, _ORDER_48, 1, 0),
         (9, 64, _ORDER_48, 4, 0)),
    57: ((1, 1, _ORDER_48, 4, 1), (3, 64, _ORDER_48, 4, 1)),
    58: ((1, 1, _ORDER_48, 4, 2), (3, 64, _ORDER_48, 4, 2)),
    59: ((1, 1, _ORDER_48, 4, 3), (3, 64, _ORDER_48, 4, 3)),
    60: ((1, 1, _ORDER_48, 4, 0), (2, 8, _ORDER_48, 4, 4),
         (9, 64, _ORDER_48, 4, 0)),
    61: ((1, 64, _ORDER_48, 4, 1),),
    62: ((1, 64, _ORDER_48, 4, 2),),
    63: ((1, 64, _ORDER_48, 4, 3),),
    64: ((1, 1, _ORDER_64, 1, 0), (2, 8, _ORDER_48, 1, 0),
         (9, 128, _ORDER_64, 1, 0)),
    65: ((1, 64, _ORDER_64, 1, 0),),
    66: ((1, 64, _ORDER_64, 1, 0),),
    67: ((1, 64, _ORDER_64, 1, 0),),
    68: ((1, 1, _ORDER_64, 2, 0), (2, 8, _ORDER_64, 1, 0),
         (9, 64, _ORDER_64, 2, 0)),
    69: ((1, 64, _ORDER_64, 2, 1),),
    70: ((1, 64, _ORDER_64, 2, 2),),
    71: ((1, 1, _ORDER_64, 2, 3), (2, 8, _ORDER_64, 2, 1),
         (9, 64, _ORDER_64, 2, 3)),
    72: ((1, 1, _ORDER_64, 4, 0), (2, 8, _ORDER_64, 1, 0),
         (9, 64, _ORDER_64, 4, 0)),
    73: ((1, 64, _ORDER_64, 4, 1),),
    74: ((1, 64, _ORDER_64, 4, 2),),
    75: ((1, 64, _ORDER_64, 4, 3),),
    76: ((1, 1, _ORDER_64, 4, 0), (2, 8, _ORDER_64, 4, 4),
         (9, 64, _ORDER_64, 4, 0)),
    77: ((1, 64, _ORDER_64, 4, 1),),
    78: ((1, 64, _ORDER_64, 4, 2),),
    79: ((1, 64, _ORDER_64, 4, 3),),
    80: ((1, 1, _ORDER_64, 8, 0), (2, 8, _ORDER_64, 4, 8),
         (9, 64, _ORDER_64, 8, 0)),
    81: ((1, 64, _ORDER_64, 8, 1),),
    82: ((1, 64, _ORDER_64, 8, 2),),
    83: ((1, 64, _ORDER_64, 8, 3),),
    84: ((1, 1, _ORDER_64, 4, 0), (2, 8, _ORDER_64, 4, 4),
         (9, 64, _ORDER_64, 4, 0)),
    85: ((1, 64, _ORDER_64, 4, 1),),
    86: ((1, 64, _ORDER_64, 4, 2),),
    87: ((1, 64, _ORDER_64, 4, 3),),
    88: ((1, 1, _ORDER_64, 8, 0), (2, 8, _ORDER_64, 8, 8),
         (9, 64, _ORDER_64, 8, 0)),
    89: ((1, 64, _ORDER_64, 8, 1),),
    90: ((1, 64, _ORDER_64, 8, 2),),
    91: ((1, 64, _ORDER_64, 8, 3),),
    92: ((1, 1, _ORDER_64, 8, 4), (2, 4, _ORDER_64, 4, 4),
         (5, 6, _ORDER_64, 8, 4), (7, 8, _ORDER_64, 4, 4),
         (9, 64, _ORDER_64, 8, 4)),
    93: ((1, 1, _ORDER_64, 8, 5), (2, 4, _ORDER_64, 4, 1),
         (5, 6, _ORDER_64, 8, 5), (7, 8, _ORDER_64, 4, 1),
         (9, 64, _ORDER_64, 8, 5)),
    94: ((1, 1, _ORDER_64, 8, 6), (2, 4, _ORDER_64, 4, 2),
         (5, 6, _ORDER_64, 8, 6), (7, 8, _ORDER_64, 4, 2),
         (9, 64, _ORDER_64, 8, 6)),
    95: ((1, 1, _ORDER_64, 8, 7), (2, 4, _ORDER_64, 4, 3),
         (5, 6, _ORDER_64, 8, 7), (7, 8, _ORDER_64, 4, 3),
         (9, 64, _ORDER_64, 8, 7)),
    96: ((1, 1, _ORDER_96, 1, 0), (2, 8, _ORDER_64, 1, 0),
         (9, 128, _ORDER_96, 1, 0)),
    97: ((1, 64, _ORDER_96, 1, 0),),
    98: ((1, 64, _ORDER_96, 1, 0),),
    99: ((1, 64, _ORDER_96, 1, 0),),
    100: ((1, 1, _ORDER_96, 2, 0), (2, 8, _ORDER_96, 1, 0),
          (9, 64, _ORDER_96, 2, 0)),
    101: ((1, 64, _ORDER_96, 2, 1),),
    102: ((1, 64, _ORDER_96, 2, 2),),
    103: ((1, 1, _ORDER_96, 2, 3), (2, 8, _ORDER_96, 2, 1),
          (9, 64, _ORDER_96, 2, 3)),
    104: ((1, 1, _ORDER_96, 4, 0), (2, 8, _ORDER_96, 1, 0),
          (9, 64, _ORDER_96, 4, 0)),
    105: ((1, 64, _ORDER_96, 4, 1),),
    106: ((1, 64, _ORDER_96, 4, 2),),
    107: ((1, 64, _ORDER_96, 4, 3),),
    108: ((1, 1, _ORDER_96, 4, 0), (2, 8, _ORDER_96, 4, 4),
          (9, 64, _ORDER_96, 4, 0)),
    109: ((1, 64, _ORDER_96, 4, 1),),
    110: ((1, 64, _ORDER_96, 4, 2),),
    111: ((1, 64, _ORDER_96, 4, 3),),
    112: ((1, 1, _ORDER_96, 8, 0), (2, 8, _ORDER_96, 4, 8),
          (9, 64, _ORDER_96, 8, 0)),
    113: ((1, 64, _ORDER_96, 8, 1),),
    114: ((1, 64, _ORDER_96, 8, 2),),
    115: ((1, 64, _ORDER_96, 8, 3),),
    116: ((1, 1, _ORDER_96, 4, 0), (2, 8, _ORDER_96, 4, 4),
          (9, 64, _ORDER_96, 4, 0)),
    117: ((1, 64, _ORDER_96, 4, 1),),
    118: ((1, 64, _ORDER_96, 4, 2),),
    119: ((1, 64, _ORDER_96, 4, 3),),
    120: ((1, 1, _ORDER_96, 8, 0), (2, 8, _ORDER_96, 8, 8),
          (9, 64, _ORDER_96, 8, 0)),
    121: ((1, 64, _ORDER_96, 8, 1),),
    122: ((1, 64, _ORDER_96, 8, 2),),
    123: ((1, 64, _ORDER_96, 8, 3),),
    124: ((1, 1, _ORDER_96, 8, 4), (2, 4, _ORDER_96, 4, 4),
          (5, 6, _ORDER_96, 8, 4), (7, 8, _ORDER_96, 4, 4),
          (9, 64, _ORDER_96, 8, 4)),
    125: ((1, 1, _ORDER_96, 8, 5), (2, 4, _ORDER_96, 4, 1),
          (5, 6, _ORDER_96, 8, 5), (7, 8, _ORDER_96, 4, 1),
          (9, 64, _ORDER_96, 8, 5)),
    126: ((1, 1, _ORDER_96, 8, 6), (2, 4, _ORDER_96, 4, 2),
          (5, 6, _ORDER_96, 8, 6), (7, 8, _ORDER_96, 4, 2),
          (9, 64, _ORDER_96, 8, 6)),
    127: ((1, 1, _ORDER_96, 8, 7), (2, 4, _ORDER_96, 4, 3),
          (5, 6, _ORDER_96, 8, 7), (7, 8, _ORDER_96, 4, 3),
          (9, 64, _ORDER_96, 8, 7)),
    128: ((1, 1, _ORDER_128, 1, 0), (2, 8, _ORDER_96, 1, 0),
          (9, 128, _ORDER_128_CHAINS, 1, 0)),
}.items()}


# The largest head XLA:CPU sums in one chain at L = 1-8 (read at every F =
# 257-512); a larger head runs in four chains there, as every head does at
# L >= 9. Every head of up to 256 flows fits one chain.
_ONE_CHAIN_HEAD = {1: 320, 2: 448, 3: 352, 4: 352, 5: 320, 6: 320, 7: 320,
                   8: 320}


def _period_rows(F: int) -> tuple:
    """The ranges of F = 129-512: those of F = 96 + F % 32 with the head of
    96 (or 64) flows made one of H = 32 * (F // 32) (or H - 32), in one
    chain up to L = 8 where the head is at most ``_ONE_CHAIN_HEAD[L]``,
    else in four (always at L = 9-64)."""
    H, r = 32 * (F // 32), F % 32
    rows = []
    for lo, hi, order in _UNBATCHED_ORDER[96 + r]:
        head = order.head + H - 96
        for a, b in ([(L, L) for L in range(lo, min(hi, 8) + 1)]
                     + [(max(lo, 9), min(hi, 64))]):
            if a > b:
                continue
            chains = 1 if b <= 8 and head <= _ONE_CHAIN_HEAD[b] else 4
            o = _head(head, chains)._replace(tail_lanes=order.tail_lanes,
                                             trailing=order.trailing)
            if rows and rows[-1][2] == o and rows[-1][1] == a - 1:
                rows[-1] = (rows[-1][0], b, o)
            else:
                rows.append((a, b, o))
    return tuple(rows)


MAX_TABLED_FLOWS = 512
MAX_TABLED_LINKS = 256
_UNBATCHED_ORDER.update({F: _period_rows(F)
                         for F in range(129, MAX_TABLED_FLOWS + 1)})


def _carry(rows: tuple) -> tuple:
    """A flow count's last range of link counts, where it ends at L = 64 or
    128, carried on to ``MAX_TABLED_LINKS``."""
    lo, hi, order = rows[-1]
    return (rows[:-1] + ((lo, MAX_TABLED_LINKS, order),) if hi in (64, 128)
            else rows)


_UNBATCHED_ORDER = {F: _carry(rows) for F, rows in _UNBATCHED_ORDER.items()}


def flow_order(n_flows: int, n_links: int, n_lanes: int) -> FlowOrder:
    """The order of the sum over flows for B lanes of (F, L): the
    reference's unbatched order on one lane where it is tabled, else left
    to right. The kernel is given the same order."""
    if n_lanes == 1:
        for lo, hi, order in _UNBATCHED_ORDER.get(n_flows, ()):
            if lo <= n_links <= hi:
                return order
    return LEFT_TO_RIGHT


def _halves(lanes: list):
    while len(lanes) > 1:
        h = len(lanes) // 2
        lanes = [lanes[k] + lanes[k + h] for k in range(h)]
    return lanes[0]


def _sum_flows(contrib: torch.Tensor, order: FlowOrder | None = None
               ) -> torch.Tensor:
    """(F, B, L) -> (B, L): the sum over flows in ``order`` (default
    :func:`flow_order` of the B lanes)."""
    F, B, L = contrib.shape[:3]
    V, blocks, chains, W, trailing = (flow_order(F, L, B) if order is None
                                      else order)
    if not V:
        acc = contrib[0]
        for f in range(1, F):
            acc = acc + contrib[f]
        return acc
    rows = contrib[:V].reshape((V // 8, 8) + contrib.shape[1:])
    run = len(blocks) // chains
    lanes = None
    for c in range(chains):
        part = rows[blocks[c * run]]
        for b in blocks[c * run + 1:(c + 1) * run]:
            part = part + rows[b]
        lanes = part if lanes is None else lanes + part
    while lanes.shape[0] > 1:
        h = lanes.shape[0] // 2
        lanes = lanes[:h] + lanes[h:]
    E = F - trailing
    tail = [lanes[0]] + [contrib[f] for f in range(V + 1, min(V + W, E))]
    if V < E:
        tail[0] = tail[0] + contrib[V]
    for f in range(V + W, E):
        tail[(f - V) % W] = tail[(f - V) % W] + contrib[f]
    acc = _halves(tail)
    for f in range(E, F):
        acc = acc + contrib[f]
    return acc


def _fill_rounds(inc: torch.Tensor, bw: torch.Tensor, active: torch.Tensor,
                 order: FlowOrder | None = None):
    """The L rounds of progressive filling: yields ``(rate, newly)`` after
    each round, ``newly`` the flows it froze."""
    B, F, L = inc.shape
    inc = inc * active[..., None].to(inc.dtype)
    big = torch.full((), _BIG, dtype=torch.float32, device=inc.device)
    rate = torch.zeros((B, F), dtype=torch.float32, device=inc.device)
    frozen = ~active
    for _ in range(L):
        unfrozen = active & ~frozen
        # integer-valued counts: exact in any summation order
        n_unf = torch.sum(inc * unfrozen[..., None].to(torch.float32), dim=1)
        contrib = (inc * (rate * frozen.to(torch.float32))[..., None]
                   ).transpose(0, 1).contiguous()          # (F, B, L)
        used = _sum_flows(contrib, order)
        resid = torch.clamp_min(bw - used, 0.0)
        fair = torch.where(n_unf > 0, resid / torch.clamp_min(n_unf, 1.0), big)
        fair = torch.where((bw <= 0) & (n_unf > 0), 0.0, fair)
        level = torch.amin(fair, dim=1, keepdim=True)
        bottleneck = fair <= level + _EPS
        hits = torch.any((inc > 0) & bottleneck[:, None, :], dim=2)
        newly = unfrozen & hits
        rate = torch.where(newly, level, rate)
        frozen = frozen | newly
        yield rate, newly


def maxmin_rates(inc: torch.Tensor, bw: torch.Tensor, active: torch.Tensor,
                 order: FlowOrder | None = None) -> torch.Tensor:
    """Progressive-filling max-min fair rates over lanes.

    inc: (B, F, L) 0/1, bw: (B, L), active: (B, F) bool -> (B, F) rates.
    L rounds, each freezing every flow that crosses a bottleneck link. The
    per-link sum of frozen rates (``inc.T @ (rate * frozen)`` in the
    reference) is a sum of explicit additions in XLA:CPU's order
    (``order``, default :func:`flow_order` of the B lanes), never a BLAS
    call or ``torch.sum``, whose orders differ between devices."""
    rate = torch.zeros(active.shape, dtype=torch.float32, device=inc.device)
    for rate, _newly in _fill_rounds(inc, bw, active, order):
        pass
    return torch.where(active, rate, 0.0)


# ------------------------------------------------------------ model zoo
NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (BH, Sq, D), k and v (BKV, Skv, D) with BH % BKV == 0: row bh
    attends KV row bh // (BH // BKV). Causal or sliding-window (``window``
    > 0: the last ``window`` keys up to the query's position) softmax in
    float32, scores scaled by 1/sqrt(D) after the product, masked scores
    -1e30; the output in q's dtype."""
    bh, sq, d = q.shape
    skv = k.shape[1]
    group = bh // k.shape[0]
    kr = k.float().repeat_interleave(group, 0)
    vr = v.float().repeat_interleave(group, 0)
    s = torch.bmm(q.float(), kr.transpose(1, 2)) * (1.0 / math.sqrt(d))
    if causal:
        qp = torch.arange(sq, device=q.device)[:, None]
        kp = torch.arange(skv, device=q.device)[None, :]
        mask = kp <= qp
        if window > 0:
            mask = mask & (kp > qp - window)
        s = s.masked_fill(~mask, NEG_INF)
    return torch.bmm(torch.softmax(s, dim=-1), vr).to(q.dtype)


def gla_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor | None = None, *,
             mode: str = "k", chunk: int = 64):
    """Chunked gated linear attention from the zero state, the math of
    ``repro.kernels.rwkv6_scan.gla_pallas``: q, k (BH, S, dk), v (BH, S, dv),
    w the decays (BH, S, dk) in mode "k" (RWKV6: decay on K, bonus ``u``
    (BH, dk) on the diagonal) or (BH, S, dv) in mode "v" (SSD: decay on V,
    inclusive diagonal, no bonus). ``chunk`` must divide S (or exceed it).
    Returns (out (BH, S, dv) in q's dtype, final state (BH, dk, dv)
    float32)."""
    if mode not in ("k", "v"):
        raise ValueError(f"gla_scan: mode must be 'k' or 'v', got {mode!r}")
    bh, s, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk, s)
    if c < 1 or s % c:
        raise ValueError(f"gla_scan: chunk {chunk} does not divide {s}")
    qf, kf, vf, wf = (x.float() for x in (q, k, v, w))
    ii = torch.arange(c, device=q.device)
    lower = ii[None, :] < ii[:, None]           # (i, j): j < i
    inclusive = ii[None, :] <= ii[:, None]
    zero = torch.zeros((), device=q.device)
    state = torch.zeros((bh, dk, dv), dtype=torch.float32, device=q.device)
    outs = []
    for c0 in range(0, s, c):
        qc, kc, vc, wc = (x[:, c0:c0 + c] for x in (qf, kf, vf, wf))
        qs = torch.exp(torch.cumsum(torch.log(wc), dim=1))   # inclusive
        last = qs[:, -1]
        if mode == "k":
            r_t = qc * (qs / wc)
            k_t = kc / qs
            a = torch.where(lower, torch.bmm(r_t, k_t.transpose(1, 2)), zero)
            if u is not None:
                diag = torch.sum(qc * u.float()[:, None, :] * kc, dim=-1)
                a = a + torch.where(ii[None, :] == ii[:, None],
                                    diag[:, :, None], zero)
            outs.append(torch.bmm(r_t, state) + torch.bmm(a, vc))
            state = (state * last[:, :, None]
                     + torch.bmm((k_t * last[:, None, :]).transpose(1, 2),
                                 vc))
        else:
            b = torch.where(inclusive, torch.bmm(qc, kc.transpose(1, 2)),
                            zero)
            v_t = vc / qs
            outs.append(qs * (torch.bmm(qc, state) + torch.bmm(b, v_t)))
            state = last[:, None, :] * (state
                                        + torch.bmm(kc.transpose(1, 2), v_t))
    return torch.cat(outs, dim=1).to(q.dtype), state
