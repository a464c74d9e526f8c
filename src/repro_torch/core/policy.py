"""Monitoring-driven adaptive exec width (counterpart of
``repro.core.policy``).

The engine's per-window knob is ``exec_cap``: how many of the earliest safe
events one conservative window executes. Too narrow under dense windows,
safe events spill (``C_EXEC_SPILL``) and the run pays extra windows; too
narrow near pool saturation, a window frees too few slots of insert
headroom; too wide on sparse windows, the batched dispatch pays for lanes
that execute nothing. :class:`ExecPolicy` picks the next window's width from
a small fixed ladder, from the per-window counter deltas. Decisions are pure
host-side functions, so an adaptive run is exactly reproducible, and
spilling is oracle-exact for any width sequence: the policy trades only the
window count and the per-window cost. The drivers across devices decide a
rung a shard and take the largest (:func:`choose_rung_lockstep`).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import monitoring as mon


@dataclasses.dataclass(frozen=True)
class ExecPolicy:
    """A ladder of per-window execution widths and the movement thresholds.

    ``ladder`` is a strictly ascending tuple of widths. One decision moves
    at most one rung. Grow (rung + 1) when this window spilled more than
    ``grow_spill`` x the current width, or pool occupancy exceeded
    ``grow_occupancy`` of pool_cap. Shrink (rung - 1) when nothing spilled,
    occupancy is comfortable, and both the executed-event count and the
    scatter volume (``C_BATCH_ROWS``) fit inside ``shrink_util`` x the next
    lower width.
    """

    ladder: tuple[int, ...]
    init_rung: int = 0
    grow_spill: float = 0.10
    grow_occupancy: float = 0.75
    shrink_util: float = 0.50

    def __post_init__(self):
        if not self.ladder:
            raise ValueError("ExecPolicy needs a non-empty width ladder")
        lad = tuple(int(w) for w in self.ladder)
        if any(w <= 0 for w in lad):
            raise ValueError(f"ladder widths must be positive: {lad}")
        if any(b <= a for a, b in zip(lad, lad[1:])):
            raise ValueError(f"ladder must be strictly ascending: {lad}")
        object.__setattr__(self, "ladder", lad)
        if not 0 <= self.init_rung < len(lad):
            raise ValueError(f"init_rung {self.init_rung} outside ladder "
                             f"{lad}")


def default_ladder(pool_cap: int, base: int = 256) -> tuple[int, ...]:
    """A geometric ladder around the static default: base/4, base, base*4,
    ... capped at ``pool_cap`` (always included)."""
    widths = {min(max(base // 4, 1), pool_cap), min(base, pool_cap)}
    w = base * 4
    while w < pool_cap:
        widths.add(w)
        w *= 4
    widths.add(pool_cap)
    return tuple(sorted(widths))


def normalize(exec_policy) -> ExecPolicy:
    """An ExecPolicy from a spec's ``exec_policy`` field (int -> one rung)."""
    if isinstance(exec_policy, ExecPolicy):
        return exec_policy
    return ExecPolicy(ladder=(int(exec_policy),))


@dataclasses.dataclass(frozen=True)
class WindowStats:
    """The per-window monitoring slice a decision consumes: per-window
    deltas reduced by ``max`` over agents (the fleet adapts to its hottest
    agent), and the worst agent's occupancy as a fraction of pool_cap."""

    processed: int    # max over agents of this window's C_EVENTS delta
    spilled: int      # max over agents of this window's C_EXEC_SPILL delta
    rows: int         # max over agents of this window's C_BATCH_ROWS delta
    occupancy: float  # max over agents of C_POOL_OCC / pool_cap


def window_stats(prev_counters, counters, pool_cap: int) -> WindowStats:
    """A :class:`WindowStats` from two (A, N) counter snapshots (numpy)."""
    prev = np.asarray(prev_counters)
    cur = np.asarray(counters)
    delta = cur - prev
    return WindowStats(
        processed=int(delta[:, mon.C_EVENTS].max()),
        spilled=int(delta[:, mon.C_EXEC_SPILL].max()),
        rows=int(delta[:, mon.C_BATCH_ROWS].max()),
        occupancy=float(cur[:, mon.C_POOL_OCC].max()) / max(pool_cap, 1),
    )


def shard_window_stats(prev_counters, counters, pool_cap: int,
                       n_shards: int) -> tuple[WindowStats, ...]:
    """Per-shard :class:`WindowStats` from two (D * K, N) counter snapshots
    of the shard-major layout: shard d owns rows ``[d*K, (d+1)*K)``."""
    prev = np.asarray(prev_counters)
    cur = np.asarray(counters)
    k = prev.shape[0] // n_shards
    return tuple(
        window_stats(prev[d * k:(d + 1) * k], cur[d * k:(d + 1) * k], pool_cap)
        for d in range(n_shards))


def choose_rung(policy: ExecPolicy, rung: int, stats: WindowStats) -> int:
    """The next window's ladder rung (pure, host-side, deterministic)."""
    width = policy.ladder[rung]
    if stats.spilled > policy.grow_spill * width:
        return min(rung + 1, len(policy.ladder) - 1)
    if stats.occupancy > policy.grow_occupancy:
        return min(rung + 1, len(policy.ladder) - 1)
    if rung > 0:
        lo = policy.ladder[rung - 1]
        sparse = (stats.spilled == 0
                  and stats.occupancy <= policy.grow_occupancy
                  and stats.processed < policy.shrink_util * lo
                  and stats.rows < policy.shrink_util * lo)
        if sparse:
            return rung - 1
    return rung


def choose_rung_lockstep(policy: ExecPolicy, rung: int,
                         shard_stats: tuple[WindowStats, ...]) -> int:
    """The fleet's next rung across shards: the largest of the shards'
    decisions. Every :func:`choose_rung` condition is monotone in the
    stats, so this is ``choose_rung`` of the stats' maxima over all rows,
    and the rung trajectory equals ``run_adaptive``'s."""
    return max(choose_rung(policy, rung, s) for s in shard_stats)
