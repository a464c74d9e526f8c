"""Per-agent monitoring counters (counterpart of ``repro.core.monitoring``,
its counter table and helpers; the host streams wait for a later slice).

Counters are an int32 vector per agent, (A, n_counters) in the engine state.
Handlers bump per-lane increment vectors of shape (B, n_counters).
"""
from __future__ import annotations

import numpy as np
import torch

# Counter indices (the same table as the reference).
C_EVENTS = 0
C_MSGS_REMOTE = 1
C_STALE = 2
C_INTERRUPTS = 3
C_JOBS_SUBMITTED = 4
C_JOBS_DONE = 5
C_FLOWS_STARTED = 6
C_FLOWS_DONE = 7
C_MB_TRANSFERRED = 8
C_DROP_POOL = 9
C_DROP_ROUTE = 10
C_DROP_FLOW = 11
C_DROP_QUEUE = 12
C_WINDOWS = 13
C_MIGRATIONS = 14
C_WRITES = 15
C_MB_WRITTEN = 16
C_LP_LOCAL = 17
C_EXEC_SPILL = 18
C_BATCH_EXEC = 19
C_BATCH_FALLBACK = 20
C_BATCH_ROWS = 21
C_TRACE_DROP = 22
C_RING_WRAP = 23
C_POOL_OCC = 24
C_POOL_FREE = 25
C_MIGRATE_OUT = 26
C_MIGRATE_IN = 27
C_PREEMPT = 28
C_RESUME = 29
C_RESHARD = 30
N_COUNTERS = 31

DROP_COUNTERS = (C_DROP_POOL, C_DROP_ROUTE, C_DROP_FLOW, C_DROP_QUEUE)

BUILTIN_COUNTERS = (
    ("EVENTS", "events processed (all execution paths)"),
    ("MSGS_REMOTE", "emits routed to another agent"),
    ("STALE", "stale (interrupted) flow-completion events — the paper's "
              "Fig-2 cost driver"),
    ("INTERRUPTS", "bandwidth-share recomputations (max-min refair)"),
    ("JOBS_SUBMITTED", "jobs accepted by a compute farm"),
    ("JOBS_DONE", "jobs completed"),
    ("FLOWS_STARTED", "WAN transfers started"),
    ("FLOWS_DONE", "WAN transfers completed"),
    ("MB_TRANSFERRED", "completed-flow megabytes (rounded to int)"),
    ("DROP_POOL", "event-pool overflow (including oversubscribed init "
                  "seeds)"),
    ("DROP_ROUTE", "routing-buffer overflow"),
    ("DROP_FLOW", "flow-table overflow (flow start refused)"),
    ("DROP_QUEUE", "job-queue overflow (job refused)"),
    ("WINDOWS", "conservative windows executed (collective sync rounds)"),
    ("MIGRATIONS", "disk -> tape migrations"),
    ("WRITES", "storage writes"),
    ("MB_WRITTEN", "written megabytes (rounded to int)"),
    ("LP_LOCAL", "emits destined to locally-owned LPs (scheduler locality "
                 "signal)"),
    ("EXEC_SPILL", "safe events deferred past exec_cap to the next window"),
    ("BATCH_EXEC", "events executed through the grouped vectorized dispatch"),
    ("BATCH_FALLBACK", "conflicted events executed via the sequential "
                       "fallback"),
    ("BATCH_ROWS", "component-table rows scattered by the batched merge — "
                   "the per-window scatter-volume signal for the adaptive "
                   "exec width"),
    ("TRACE_DROP", "trace records lost to the fixed-cap trace buffer, or "
                   "overwritten un-drained ring rows under streaming; "
                   "oracle.merged_engine_trace and TraceStream refuse a "
                   "truncated trace, so oracle-equivalence checks fail "
                   "loudly instead of passing on a prefix"),
    ("RING_WRAP", "free-ring cursor wraps (head on insert, tail on release) "
                  "— pool-recycling pressure"),
    ("POOL_OCC", "live pool slots at window end — the saturation signal the "
                 "adaptive exec policy grows on"),
    ("POOL_FREE", "free pool slots at window end (insert headroom)"),
    ("MIGRATE_OUT", "events shipped to another agent by a placement change "
                    "(donor side, post route-cap)"),
    ("MIGRATE_IN", "migrated events received (counted pre-insert, so "
                   "sum(OUT) == sum(IN) globally even when the receiving "
                   "pool overflows — the excess then lands in DROP_POOL on "
                   "the receiver)"),
    ("PREEMPT", "shard-loss preemptions the fleet orchestrator detected "
                "(injected probe or a process death discovered at restart)"),
    ("RESUME", "automatic checkpoint resumes the orchestrator completed "
               "after a preemption"),
    ("RESHARD", "resumes that repacked the unpadded checkpoint onto a "
                "different device count than it was saved from"),
)
assert len(BUILTIN_COUNTERS) == N_COUNTERS


def zero_counters(n: int | None = None, lanes: int | None = None,
                  device="cpu") -> torch.Tensor:
    """A zero counter vector, or (lanes, n) zero increment vectors."""
    n = N_COUNTERS if n is None else n
    shape = (n,) if lanes is None else (lanes, n)
    return torch.zeros(shape, dtype=torch.int32, device=device)


def bump(counters: torch.Tensor, idx: int, amount=1) -> torch.Tensor:
    """``counters[..., idx] += amount`` (out of place; ``amount`` is a
    scalar or one value per leading row)."""
    out = counters.clone()
    if isinstance(amount, torch.Tensor):
        amount = amount.to(torch.int32)
    out[..., idx] += amount
    return out


def gauge(counters: torch.Tensor, idx: int, value) -> torch.Tensor:
    """Overwrite a gauge counter (per-window level, not an accumulation)."""
    out = counters.clone()
    if isinstance(value, torch.Tensor):
        value = value.to(torch.int32)
    out[..., idx] = value
    return out


def snapshot(counters, registry=None) -> dict:
    """Named view ``{counter name: int total}`` of an (n,) vector or an
    (A, n) fleet (summed over agents)."""
    names = (registry.counters if registry is not None
             else {name: i for i, (name, _doc) in enumerate(BUILTIN_COUNTERS)})
    c = np.asarray(counters.cpu() if isinstance(counters, torch.Tensor)
                   else counters)
    if c.ndim == 2:
        c = c.sum(axis=0)
    return {name: int(c[i]) for name, i in names.items()}
