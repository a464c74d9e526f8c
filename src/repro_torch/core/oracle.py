"""Sequential discrete-event oracle (counterpart of ``repro.core.oracle``).

One event at a time in exact global (time, seq) order off a binary heap, on
the CPU. State transitions reuse the port's handlers, called with a one-agent
world and one lane holding the event's own kind, so a divergence from the
engine isolates the windowing, routing and sync machinery.
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

from repro_torch.core import monitoring as mon
from repro_torch.core.handlers import _mark_processed
from repro_torch.core.registry import Ev, registry_of

I32 = torch.int32


def run_sequential(world, own, init_events, spec, max_events: int = 100_000):
    """Returns (final_world, counters, trace) with trace = [(time, seq, kind,
    dst)]; ``world`` is the builder's unstacked world."""
    reg = registry_of(world)
    table = reg.make_handlers(spec.lookahead, spec.work_per_mb)
    w = world.__class__(*(x.cpu()[None].clone() for x in world))
    counters = mon.zero_counters(reg.n_counters)

    heap: list[tuple[int, int, int]] = []
    rows: dict[int, tuple] = {}
    uid = 0

    def push(batch):
        nonlocal uid
        cols = [np.asarray(x.cpu()) for x in batch]
        time, seq, kind, src, dst, ctx, payload, valid = cols
        for i in np.flatnonzero(valid.reshape(-1)):
            rows[uid] = (int(time.flat[i]), int(seq.flat[i]),
                         int(kind.flat[i]), int(src.flat[i]),
                         int(dst.flat[i]), int(ctx.flat[i]),
                         payload.reshape(-1, payload.shape[-1])[i].copy())
            heapq.heappush(heap, (int(time.flat[i]), int(seq.flat[i]), uid))
            uid += 1

    push(init_events)
    one = torch.ones((1,), dtype=torch.bool)
    zero_c = mon.zero_counters(reg.n_counters, 1)
    trace: list[tuple[int, int, int, int]] = []
    n = 0
    while heap and n < max_events:
        t, s, u = heapq.heappop(heap)
        if t >= spec.t_end:
            break   # beyond the simulation horizon, as the engine's clamp
        time, seq, kind, src, dst, ctx, payload = rows.pop(u)
        e = Ev(*(torch.tensor([v], dtype=I32)
                 for v in (time, seq, kind, src, dst, ctx)),
               payload=torch.from_numpy(payload)[None],
               agent=torch.zeros((1,), dtype=I32))
        k = min(max(kind, 0), len(table) - 1)
        delta, cinc, out = table[k](w, zero_c, e)
        w = reg.apply_delta(w, delta, e.agent)
        w = _mark_processed(w, e, one)
        w = w._replace(lp_state=torch.where(w.lp_state == 2, 3, w.lp_state))
        counters = counters + cinc[0]
        trace.append((time, seq, kind, dst))
        n += 1
        push(out)

    counters = mon.bump(counters, mon.C_EVENTS, n)
    return world.__class__(*(x[0] for x in w)), counters, trace


def merged_engine_trace(trace, trace_n):
    """Merge per-agent engine traces (A, cap, 4) into global (time, seq)
    order; refuses a truncated trace (``trace_n`` beyond the buffer)."""
    trace = np.asarray(trace.cpu() if isinstance(trace, torch.Tensor)
                       else trace)
    trace_n = np.asarray(trace_n.cpu() if isinstance(trace_n, torch.Tensor)
                         else trace_n)
    over = [(a, int(trace_n[a])) for a in range(trace.shape[0])
            if int(trace_n[a]) > trace.shape[1]]
    if over:
        raise RuntimeError(
            f"trace buffer overflowed (cap={trace.shape[1]}): per-agent "
            f"(agent, events) {over}; raise Engine(trace_cap=...)")
    rows = []
    for a in range(trace.shape[0]):
        for i in range(int(trace_n[a])):
            rows.append(tuple(int(x) for x in trace[a, i]))
    rows.sort(key=lambda r: (r[0], r[1]))
    return rows
