"""Event handlers of the four builtin components (paper §4.2), written
batch-wise over a lane dimension (counterpart of ``repro.core.handlers``).

A handler ``fn(env, world, counters, e)`` reads the stacked (A, ...) world at
``(e.agent, lp_res[e.dst])`` for each of its B lanes and returns
``(delta, counters, emits)``: a delta dict writing one row of its declared
component (see ``Registry.make_delta``), the (B, n_counters) increments, and
a (B, MAX_EMIT) emit batch. The delta contract of the reference holds
unchanged: row locality, whole-row writes, the disjoint-write guarantee the
conflict mask keys on, and emit delays clamped to the lookahead.

The reference evaluates every handler on every lane under a vmapped
``lax.switch``; :func:`dispatch_delta` evaluates each kind's handler over
all lanes and keeps the lanes of that kind (a masked full-width evaluation
with static shapes), skipping the kinds the caller knows no lane holds. The
merge does not depend on order, so the result is the same.
"""
from __future__ import annotations

import torch

from repro_torch.core import events as ev
from repro_torch.core import monitoring as mon
from repro_torch.core import network as net
from repro_torch.core import tensor_util as tu
from repro_torch.core.components import (BUILTIN, FLOW_END, GEN_TICK, JOB_END,
                                         K_DATA_WRITE, K_FLOW_END,
                                         K_FLOW_START, K_GEN_TICK, K_JOB_END,
                                         K_JOB_SUBMIT, K_MIGRATE, K_NOOP,
                                         MIGRATE)
from repro_torch.core.registry import NO_ROW, Ev, Registry, registry_of

f32, i32 = torch.float32, torch.int32


class Emits:
    """A (B, MAX_EMIT) emit batch filled slot by slot (the handler owns the
    fresh tensors, so slots are written in place)."""

    def __init__(self, e: Ev):
        self.b = ev.empty_batch((e.time.shape[0], ev.MAX_EMIT),
                                device=e.time.device)
        self.e = e

    def set(self, slot: int, *, valid, time, kind, dst, payload):
        """Write one slot; src/ctx come from the parent event and seq is the
        functional child id."""
        e, b = self.e, self.b
        b.time[:, slot] = time
        b.seq[:, slot] = ev.child_seq(e.seq, slot)
        b.kind[:, slot] = kind
        b.src[:, slot] = e.dst
        b.dst[:, slot] = dst
        b.ctx[:, slot] = e.ctx
        b.payload[:, slot] = payload
        b.valid[:, slot] = valid

    def batch(self) -> ev.EventBatch:
        return self.b


def pad_payload(vals, n: int, device) -> torch.Tensor:
    """(B, PAYLOAD) payload rows from a list of (B,) columns (ints cast to
    float32, the rest zero)."""
    out = torch.zeros((n, ev.PAYLOAD), dtype=f32, device=device)
    for i, v in enumerate(vals):
        out[:, i] = v.to(f32) if isinstance(v, torch.Tensor) else v
    return out


def _row(world, name, e, r):
    return tu.take(getattr(world, name), e.agent, r)


def _lanes(e):
    return torch.arange(e.time.shape[0], device=e.time.device)


def start_queued_job(env, world, f, slot, e: Ev, out: Emits,
                     emit_slot: int = 0):
    """Pop the farm FIFO head (if any) onto CPU ``slot`` of farm row ``f``;
    its completion lands as a JOB_END emit. Returns (busy_value, mem_value,
    jobq', jobq_n')."""
    B = e.time.shape[0]
    jq = _row(world, "jobq", e, f)                         # (B, Q, 6)
    qn0 = _row(world, "jobq_n", e, f)
    has_q = qn0 > 0
    head = jq[:, 0]
    shifted = torch.cat([jq[:, 1:], torch.zeros_like(jq[:, :1])], 1)
    new_jq = torch.where(has_q[:, None, None], shifted, jq)
    new_qn = qn0 - has_q.to(i32)
    busy_v = has_q.to(i32)
    mem_v = torch.where(has_q, head[:, 1], 0.0)
    power_row = _row(world, "cpu_power", e, f)
    power = power_row[_lanes(e), slot.clamp(0, power_row.shape[1] - 1)]
    dur = tu.f2i(torch.ceil(head[:, 0] / torch.clamp_min(power, 1e-6)))
    out.set(emit_slot, valid=has_q, time=e.time + env.delay(dur),
            kind=JOB_END.id, dst=e.dst,
            payload=pad_payload([slot, head[:, 0], head[:, 1], head[:, 2],
                                 head[:, 3], head[:, 4]], B, e.time.device))
    return busy_v, mem_v, new_jq, new_qn


def set_slot(row: torch.Tensor, slot: torch.Tensor, value) -> torch.Tensor:
    """``row.at[slot].set(value)`` per lane; out-of-range slots are dropped."""
    n = row.shape[1]
    ok = (slot >= 0) & (slot < n)
    sc = slot.clamp(0, n - 1)
    lanes = torch.arange(row.shape[0], device=row.device)
    out = row.clone()
    out[lanes, sc] = torch.where(ok, value, row[lanes, sc]).to(row.dtype)
    return out


def register_builtin_handlers(reg: Registry) -> None:
    """Attach the four builtin components' handlers to ``reg``."""

    @reg.on(K_NOOP)
    def h_noop(env, world, counters, e: Ev):
        return env.empty_delta(world), counters, Emits(e).batch()

    @reg.on(K_GEN_TICK)
    def h_gen_tick(env, world, counters, e: Ev):
        g = _row(world, "lp_res", e, e.dst)
        left = _row(world, "gen_left", e, g)
        fire = left > 0
        new_left = left - fire.to(i32)
        out = Emits(e)
        out.set(0, valid=fire, time=e.time + env.delay(1),
                kind=_row(world, "gen_kind", e, g),
                dst=_row(world, "gen_target", e, g),
                payload=_row(world, "gen_payload", e, g))
        out.set(1, valid=fire & (left > 1),
                time=e.time + env.delay(_row(world, "gen_interval", e, g)),
                kind=GEN_TICK.id, dst=e.dst, payload=0.0)
        delta = env.delta(world, "gen", g, gen_left=new_left)
        return delta, counters, out.batch()

    # payload: [work, mem, notify_lp, notify_kind, size]
    @reg.on(K_JOB_SUBMIT)
    def h_job_submit(env, world, counters, e: Ev):
        B, dev = e.time.shape[0], e.time.device
        lanes = _lanes(e)
        f = _row(world, "lp_res", e, e.dst)
        busy = _row(world, "cpu_busy", e, f)
        memr = _row(world, "cpu_mem", e, f)
        jq = _row(world, "jobq", e, f)
        qn0 = _row(world, "jobq_n", e, f)
        power_row = _row(world, "cpu_power", e, f)
        work, mem = e.payload[:, 0], e.payload[:, 1]
        counters = mon.bump(counters, mon.C_JOBS_SUBMITTED)

        free = (busy == 0) & (power_row > 0)
        has_free = torch.any(free, dim=1)
        slot = torch.argmax(free.to(i32), dim=1).to(i32)
        power = power_row[lanes, slot]
        dur = tu.f2i(torch.ceil(work / torch.clamp_min(power, 1e-6)))
        finish = e.time + env.delay(dur)
        busy = busy.clone()
        busy[lanes, slot] += has_free.to(i32)
        memr = memr.clone()
        memr[lanes, slot] = memr[lanes, slot] + torch.where(has_free, mem, 0.0)

        qcap = jq.shape[1]
        can_q = (~has_free) & (qn0 < qcap)
        qrow = torch.cat([e.payload[:, :5], torch.zeros_like(work)[:, None]],
                         1)
        qi = torch.where(can_q, qn0, 0).clamp(0, qcap - 1)
        jq = jq.clone()
        jq[lanes, qi] = torch.where(can_q[:, None], qrow, jq[lanes, qi])
        new_qn = qn0 + can_q.to(i32)
        counters = mon.bump(counters, mon.C_DROP_QUEUE,
                            ((~has_free) & (qn0 >= qcap)).to(i32))

        out = Emits(e)
        out.set(0, valid=has_free, time=finish, kind=JOB_END.id, dst=e.dst,
                payload=pad_payload([slot, work, mem, e.payload[:, 2],
                                     e.payload[:, 3], e.payload[:, 4]],
                                    B, dev))
        delta = env.delta(world, "farm", f, cpu_busy=busy, cpu_mem=memr,
                          jobq=jq, jobq_n=new_qn)
        return delta, counters, out.batch()

    # payload: [slot, work, mem, notify_lp, notify_kind, size]
    @reg.on(K_JOB_END)
    def h_job_end(env, world, counters, e: Ev):
        B, dev = e.time.shape[0], e.time.device
        f = _row(world, "lp_res", e, e.dst)
        slot = tu.f2i(e.payload[:, 0])
        counters = mon.bump(counters, mon.C_JOBS_DONE)
        out = Emits(e)
        busy_v, mem_v, new_jq, new_qn = start_queued_job(env, world, f, slot,
                                                         e, out, 0)
        busy = set_slot(_row(world, "cpu_busy", e, f), slot, busy_v)
        memr = set_slot(_row(world, "cpu_mem", e, f), slot, mem_v)
        nlp = tu.f2i(e.payload[:, 3])
        nkind = tu.f2i(e.payload[:, 4])
        out.set(1, valid=nlp >= 0, time=e.time + env.delay(1), kind=nkind,
                dst=torch.clamp_min(nlp, 0),
                payload=pad_payload([e.payload[:, 5]], B, dev))
        delta = env.delta(world, "farm", f, cpu_busy=busy, cpu_mem=memr,
                          jobq=new_jq, jobq_n=new_qn)
        return delta, counters, out.batch()

    def _reshare_and_schedule(env, counters, e: Ev, links_row, bw_row,
                              active_row, rem_row, tlast_row, gen0):
        """Recompute a region row's fair shares, schedule its next completion."""
        inc = net.incidence(links_row, bw_row.shape[-1])
        rates = net.maxmin_rates(inc, bw_row, active_row)
        counters = mon.bump(counters, mon.C_INTERRUPTS)
        gen = gen0 + 1
        t_fin = net.completion_times(rem_row, rates, tlast_row, active_row)
        tmin = torch.amin(t_fin, dim=1)
        any_active = torch.any(active_row, dim=1)
        t_next = torch.maximum(tmin, e.time + env.delay(0))
        return rates, gen, counters, any_active, t_next

    # payload: [size, l0, l1, l2, notify_lp, notify_kind, notify2_lp,
    #           notify2_kind]
    @reg.on(K_FLOW_START)
    def h_flow_start(env, world, counters, e: Ev):
        B, dev = e.time.shape[0], e.time.device
        lanes = _lanes(e)
        r = _row(world, "lp_res", e, e.dst)
        active = _row(world, "flow_active", e, r)
        rate = _row(world, "flow_rate", e, r)
        links = _row(world, "flow_links", e, r)
        notif = _row(world, "flow_notify", e, r)
        size = e.payload[:, 0]
        counters = mon.bump(counters, mon.C_FLOWS_STARTED)

        rem, tlast = net.progress_flows(_row(world, "flow_rem", e, r), rate,
                                        _row(world, "flow_tlast", e, r),
                                        active, e.time)
        free = ~active
        has_free = torch.any(free, dim=1)
        s = torch.argmax(free.to(i32), dim=1)
        counters = mon.bump(counters, mon.C_DROP_FLOW, (~has_free).to(i32))

        route = tu.f2i(e.payload[:, 1:4])
        nrow = torch.stack([e.payload[:, 4], e.payload[:, 5],
                            size * env.work_per_mb, size, e.payload[:, 6],
                            e.payload[:, 7]], 1)
        active, rem, tlast = active.clone(), rem.clone(), tlast.clone()
        links, notif = links.clone(), notif.clone()
        active[lanes, s] = torch.where(has_free, True, active[lanes, s])
        rem[lanes, s] = torch.where(has_free, size, rem[lanes, s])
        tlast[lanes, s] = torch.where(has_free, e.time, tlast[lanes, s])
        links[lanes, s] = torch.where(has_free[:, None], route,
                                      links[lanes, s])
        notif[lanes, s] = torch.where(has_free[:, None], nrow,
                                      notif[lanes, s])

        rates, gen, counters, any_active, t_next = _reshare_and_schedule(
            env, counters, e, links, _row(world, "link_bw", e, r), active,
            rem, tlast, _row(world, "net_gen", e, r))
        out = Emits(e)
        out.set(2, valid=any_active, time=t_next, kind=FLOW_END.id, dst=e.dst,
                payload=pad_payload([gen], B, dev))
        delta = env.delta(world, "net", r, flow_active=active, flow_rem=rem,
                          flow_rate=rates, flow_tlast=tlast, flow_links=links,
                          flow_notify=notif, net_gen=gen)
        return delta, counters, out.batch()

    # payload: [gen]
    @reg.on(K_FLOW_END)
    def h_flow_end(env, world, counters, e: Ev):
        B, dev = e.time.shape[0], e.time.device
        lanes = _lanes(e)
        r = _row(world, "lp_res", e, e.dst)
        gen_ok = tu.f2i(e.payload[:, 0]) == _row(world, "net_gen", e, r)
        counters = mon.bump(counters, mon.C_STALE, (~gen_ok).to(i32))
        # the reference's lax.cond(gen_ok, live, stale): the live branch over
        # every lane, then the stale lanes keep no delta, no emits and only
        # the STALE bump
        active = _row(world, "flow_active", e, r)
        rem, tlast = net.progress_flows(_row(world, "flow_rem", e, r),
                                        _row(world, "flow_rate", e, r),
                                        _row(world, "flow_tlast", e, r),
                                        active, e.time)
        done = active & (rem <= 1e-3)
        F = done.shape[1]
        key = torch.where(done, tu.arange(F, dev)[None], 1 << 20)
        order = torch.sort(key, dim=1, stable=True).indices
        d0, d1 = order[:, 0], order[:, 1]
        c0, c1 = done[lanes, d0], done[lanes, d1]
        active2 = active.clone()
        active2[lanes, d0] = torch.where(c0, False, active2[lanes, d0])
        active2[lanes, d1] = torch.where(c1, False, active2[lanes, d1])
        n_done = c0.to(i32) + c1.to(i32)
        live = mon.bump(counters, mon.C_FLOWS_DONE, n_done)
        notif = _row(world, "flow_notify", e, r)
        mb = (torch.where(c0, notif[lanes, d0, 3], 0.0)
              + torch.where(c1, notif[lanes, d1, 3], 0.0))
        live = mon.bump(live, mon.C_MB_TRANSFERRED, tu.f2i(torch.round(mb)))
        links = _row(world, "flow_links", e, r)
        rates, gen, live, any_active, t_next = _reshare_and_schedule(
            env, live, e, links, _row(world, "link_bw", e, r), active2, rem,
            tlast, _row(world, "net_gen", e, r))
        counters = torch.where(gen_ok[:, None], live, counters)

        out = Emits(e)
        for slot, (di, ci) in enumerate([(d0, c0), (d1, c1)]):
            note = notif[lanes, di]
            nlp = tu.f2i(note[:, 0])
            out.set(slot, valid=gen_ok & ci & (nlp >= 0),
                    time=e.time + env.delay(1), kind=tu.f2i(note[:, 1]),
                    dst=torch.clamp_min(nlp, 0),
                    payload=pad_payload([note[:, 2], note[:, 3], note[:, 4],
                                         note[:, 5], note[:, 3]], B, dev))
        out.set(2, valid=gen_ok & any_active, time=t_next, kind=FLOW_END.id,
                dst=e.dst, payload=pad_payload([gen], B, dev))
        delta = env.delta(world, "net", torch.where(gen_ok, r, NO_ROW),
                          flow_active=active2, flow_rem=rem, flow_rate=rates,
                          flow_tlast=tlast, flow_links=links,
                          flow_notify=notif, net_gen=gen)
        return delta, counters, out.batch()

    # payload: [size]
    @reg.on(K_DATA_WRITE)
    def h_data_write(env, world, counters, e: Ev):
        B, dev = e.time.shape[0], e.time.device
        s = _row(world, "lp_res", e, e.dst)
        size = e.payload[:, 0]
        counters = mon.bump(counters, mon.C_WRITES)
        counters = mon.bump(counters, mon.C_MB_WRITTEN,
                            tu.f2i(torch.round(size)))
        used_row = _row(world, "sto_used", e, s).clone()
        used = used_row[:, 0] + size
        used_row[:, 0] = used
        cap0 = _row(world, "sto_cap", e, s)[:, 0]
        flag0 = _row(world, "sto_flag", e, s)
        over = (used > 0.9 * cap0) & (flag0 == 0)
        amount = torch.clamp_min(tu.fms(used, 0.7, cap0), 0.0)
        dur = tu.f2i(torch.ceil(
            amount / torch.clamp_min(_row(world, "sto_rate", e, s), 1e-6)))
        new_flag = torch.where(over, 1, flag0)
        out = Emits(e)
        out.set(0, valid=over, time=e.time + env.delay(dur), kind=MIGRATE.id,
                dst=e.dst, payload=pad_payload([amount], B, dev))
        delta = env.delta(world, "sto", s, sto_used=used_row,
                          sto_flag=new_flag)
        return delta, counters, out.batch()

    # payload: [amount]
    @reg.on(K_MIGRATE)
    def h_migrate(env, world, counters, e: Ev):
        s = _row(world, "lp_res", e, e.dst)
        used_row = _row(world, "sto_used", e, s).clone()
        amount = torch.minimum(e.payload[:, 0], used_row[:, 0])
        used_row[:, 0] = used_row[:, 0] + (-amount)
        used_row[:, 1] = used_row[:, 1] + amount
        counters = mon.bump(counters, mon.C_MIGRATIONS)
        delta = env.delta(world, "sto", s, sto_used=used_row, sto_flag=0)
        return delta, counters, Emits(e).batch()


register_builtin_handlers(BUILTIN)


def dispatch_delta(table, world, e: Ev, n_counters: int, kinds=None):
    """Every kind's handler over all lanes, each lane keeping its own kind's
    result (kinds are clamped into the table, as ``lax.switch`` does).
    ``kinds`` names the kinds that occur among the lanes whose results are
    used (default: all); the others are not evaluated, since no lane would
    keep their result. Returns ``(delta, counter increments, emits)`` of
    the lanes; the delta holds the tables the evaluated kinds write, with
    ``NO_ROW`` on the lanes of other kinds."""
    row_fields = registry_of(world).row_fields
    B, dev = e.time.shape[0], e.time.device
    kind = e.kind.clamp(0, len(table) - 1)
    delta = {}
    counters = mon.zero_counters(n_counters, B, dev)
    out = ev.empty_batch((B, ev.MAX_EMIT), device=dev)
    zero = mon.zero_counters(n_counters, B, dev)
    for k, fn in enumerate(table):
        if kinds is not None and k not in kinds:
            continue
        d, c, o = fn(world, zero, e)
        sel = kind == k
        for name, v in d.items():
            if name not in delta:
                delta[name] = (torch.full_like(v, NO_ROW) if name in row_fields
                               else torch.zeros_like(v))
            delta[name] = torch.where(
                sel.reshape((B,) + (1,) * (v.ndim - 1)), v, delta[name])
        counters = torch.where(sel[:, None], c, counters)
        out = ev.EventBatch(*(torch.where(
            sel.reshape((B,) + (1,) * (a.ndim - 1)), a, b)
            for a, b in zip(o, out)))
    return delta, counters, out


def apply_delta(world, delta, agent):
    """Scatter a lane batch of deltas into the stacked world."""
    return registry_of(world).apply_delta(world, delta, agent)


def apply_handler(table, world, counters, e: Ev, active: torch.Tensor,
                  kinds=None):
    """One event per agent, sequential contract: lane ``i`` runs on agent
    ``e.agent[i]``'s world (distinct agents). Lanes with ``active`` False
    change nothing; ``kinds`` as in :func:`dispatch_delta`. Returns
    (world', counters', emits)."""
    n_counters = counters.shape[-1]
    delta, cinc, out = dispatch_delta(table, world, e, n_counters, kinds)
    delta = _mask_lanes(world, delta, active)
    world = apply_delta(world, delta, e.agent)
    world = _mark_processed(world, e, active)
    counters = counters.index_add(
        0, e.agent.long(), torch.where(active[:, None], cinc, 0))
    return world, counters, out._replace(valid=out.valid & active[:, None])


def _mask_lanes(world, delta, active):
    """Out-of-range the row declarations of inactive lanes."""
    return {k: (torch.where(active, v, NO_ROW)
                if k in registry_of(world).row_fields else v)
            for k, v in delta.items()}


def _count_rows(world, masked, agent, n_agents) -> torch.Tensor:
    """(A,) component-table rows the batched phase scatters per agent."""
    n = torch.zeros((n_agents,), dtype=i32, device=agent.device)
    for rf in registry_of(world).row_fields:
        if rf in masked:
            n = n.index_add(0, agent.long(), (masked[rf] != NO_ROW).to(i32))
    return n


def _mark_processed(world, e: Ev, active):
    """``lp_lvt`` max-scatter and the RUNNING mark (both commute across
    duplicate destinations)."""
    dst = torch.where(active, e.dst, world.lp_lvt.shape[1])
    return world._replace(
        lp_lvt=tu.scatter_lanes(world.lp_lvt, e.agent, dst, e.time,
                                reduce="amax"),
        lp_state=tu.scatter_lanes(world.lp_state, e.agent, dst, 2))


def _apply_batch(table, world, rows: ev.EventBatch, active: torch.Tensor,
                 kinds, merge):
    """One batched handler evaluation over a window's (A, m) rows; ``merge``
    writes the masked lane deltas into the world."""
    A, m = rows.time.shape
    n_counters = registry_of(world).n_counters
    agent = torch.arange(A, dtype=i32, device=rows.time.device)
    agent = agent[:, None].expand(A, m).reshape(-1)
    flat = rows.map(lambda x: x.reshape((A * m,) + x.shape[2:]))
    e = Ev(*flat[:7], agent=agent)
    act = active.reshape(-1)
    delta, lanes_counters, lanes_out = dispatch_delta(table, world, e,
                                                      n_counters, kinds)
    masked = _mask_lanes(world, delta, act)
    n_rows = _count_rows(world, masked, agent, A)
    world = merge(world, masked, agent, act)
    cdelta = torch.where(act[:, None], lanes_counters, 0).reshape(
        A, m, n_counters).sum(1, dtype=i32)
    cdelta[:, mon.C_BATCH_ROWS] += n_rows
    world = _mark_processed(world, e, act)
    out = lanes_out._replace(valid=lanes_out.valid & act[:, None])
    return world, cdelta, out.map(
        lambda x: x.reshape((A, m) + x.shape[1:]))


def apply_handler_batch(table, world, rows: ev.EventBatch,
                        active: torch.Tensor, kinds=None):
    """Dispatch a window's (A, m) candidate rows through one batched handler
    evaluation and merge with per-row segment scatters.

    The caller guarantees that the ``active`` rows of an agent declare
    pairwise-distinct component rows (``sync.conflict_mask``), so the merge
    is exact; ``kinds`` lists the kinds of the active rows (default: all).
    Returns ``(world', counter_delta (A, n), emits (A, m, MAX_EMIT))``; the
    counter delta includes C_BATCH_ROWS."""
    return _apply_batch(table, world, rows, active, kinds,
                        lambda w, d, agent, _act: apply_delta(w, d, agent))


def _merge_dense(world, masked, agent, act):
    """Every lane writes its delta into a full copy of its agent's tables;
    each element then takes the copy of the first active lane (in lane
    order) that differs from the base (``!=``, so an equal write keeps the
    base's bytes and a NaN base takes the first active lane's copy), else
    the base."""
    A = world.lp_kind.shape[0]
    n = agent.shape[0]
    m = n // A
    lane = torch.arange(n, dtype=i32, device=agent.device)
    pos = tu.arange(m, agent.device)
    out = {}
    for f, rf in registry_of(world).delta_schema.items():
        if f not in masked:
            continue    # no lane's kind writes it: every copy is the base
        base = getattr(world, f)
        copies = tu.scatter_lanes(base[agent.long()], lane, masked[rf],
                                  masked[f])
        copies = copies.reshape((A, m) + base.shape[1:])
        ones = (1,) * (base.ndim - 1)
        changed = (act.reshape((A, m) + ones)
                   & (copies != base[:, None]))
        first = torch.where(changed, pos.reshape((1, m) + ones), m).amin(1)
        picked = torch.gather(copies, 1,
                              first.clamp(max=m - 1).long()[:, None])[:, 0]
        out[f] = torch.where(first < m, picked, base)
    return world._replace(**out)


def apply_handler_batch_dense(table, world, rows: ev.EventBatch,
                              active: torch.Tensor, kinds=None):
    """:func:`apply_handler_batch` with the whole-table merge of
    ``merge_mode="dense"`` (O(lanes x tables), the reference merge the
    per-row delta scatter replaced)."""
    return _apply_batch(table, world, rows, active, kinds, _merge_dense)
