"""The simulation engine: conservative-window superstep + host-stepped run
loop (counterpart of ``repro.core.engine``).

Per window, over the A agents of a shard at once (every tensor leads with
the shard's rows):

  1-2. GVT: per-context local min pending time -> min over agents; the
       safe mask is every event strictly below the horizon.
  3.   Select: the first ``exec_cap`` slots of the stable (time, seq) sort
       with unsafe slots keyed T_INF (``select_fn``, the ``select_events``
       kernel on the card).
  4.   Execute: conflict mask, ``group_fn`` (the ``group_by_kind`` kernel),
       one batched handler evaluation merged by per-row delta scatters, the
       sequential fallback for conflicted rows, the trace append
       (``trace_fn``, the ``trace_rank`` kernel) and the emit compaction.
  5-6. Route the emits by destination agent (``route_fn``, the
       ``route_rank`` kernel) into (A_dst, route_cap) send blocks, exchange
       them (every agent receives its blocks in ascending source order),
       then insert them into the free ring.
  7.   Owner-wins sync of the replicated world and the pool gauges.

The window is written once, for one shard (``_window``, a generator):
the GVT's min, the host read, the exchange and the owner-wins sum are the
points where it needs the other shards, and ``core/shards.py`` resolves
them over all shards in lockstep. ``run_local``, ``run_adaptive`` and
``run_ensemble`` run one shard holding every row, where those points are
reductions over the leading dimension; ``run_distributed`` and
``run_distributed_adaptive`` run ``K = ceil(A / D)`` agents on each of the
D devices of a mesh (the state padded with inert agents), each shard
launching its own kernels at K rows.

``spec.fused_select`` replaces the select, gather, conflict mask, grouping
and release ranks of steps 3-4 with one ``fused_fn`` call (the
``fused_select`` kernel on the card) and the insert's slot math with
``slot_fn`` (the ``ring_slots`` kernel). ``spec.insert_mode="ref"`` inserts
by an O(pool_cap) rank scan and reclaims by a pool-wide mask;
``spec.merge_mode="dense"`` merges the batched handlers' writes through
whole-table copies. All options give the same trace, counters and world;
``insert_mode`` changes the slot layout and the ring diagnostics.

``run_ensemble`` runs R seeded replicas of the state as one fleet of R * A
rows: every per-agent step (and kernel launch) takes all rows at once, and
the GVT, the routing exchange and the owner-wins sync act within each
replica's A rows (``Engine._replicas``).

The reference runs this inside a jitted ``while_loop``; here the host steps
one window at a time and syncs twice per window: it reads ``done`` (with
``trace_n`` when a trace stream is attached), and it reads one small tensor
of every shard, holding the conflict-fallback counts (the sequential fold's
trip count), the kinds among the fallback rows and which kinds the clean
rows hold. Streams
read more only on the windows that use it: the trace ring on drain windows,
the counters on metrics windows. ``Engine.host_reads`` counts the reads. The reference evaluates every handler on every lane; the
port skips the handlers of kinds that no lane holds, which no lane's result
depends on. Steps are labelled for ``torch.profiler`` (``window.*``,
``execute.*``; the points between shards ``window.gvt``, ``.read``,
``.exchange`` and ``.owner_sum``).
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import events as ev
from repro_torch.core import monitoring as mon
from repro_torch.core import policy as pol
from repro_torch.core import shards as sh
from repro_torch.core import sync
from repro_torch.core import tensor_util as tu
from repro_torch.core.handlers import (apply_handler, apply_handler_batch,
                                       apply_handler_batch_dense)
from repro_torch.core.registry import Ev, ScenarioSpec, registry_of
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.ref import FusedSelect

I32 = torch.int32


class EngineState(NamedTuple):
    world: tuple             # the registry's World, every field (A, ...)
    pool: ev.EventPool
    counters: torch.Tensor   # i32 (A, n_counters)
    t_now: torch.Tensor      # i32 (A,)  agent LVT (== last horizon)
    done: torch.Tensor       # bool (A,) (uniform over agents)
    windows: torch.Tensor    # i32 (A,)
    trace: torch.Tensor      # i32 (A, trace_cap, 4): (time, seq, kind, dst)
    trace_n: torch.Tensor    # i32 (A,)  rows ever written
    trace_tail: torch.Tensor  # i32 (A,) rows drained to the host


def _to(x, device):
    return type(x)(*(t.to(device) for t in x))


def map_state(fn, *states: EngineState) -> EngineState:
    """``fn`` over every tensor of one or more states, field by field."""
    first = states[0]
    return EngineState(
        world=type(first.world)(*map(fn, *(s.world for s in states))),
        pool=type(first.pool)(*map(fn, *(s.pool for s in states))),
        **{k: fn(*(getattr(s, k) for s in states))
           for k in EngineState._fields[2:]})


def seed_rng_fields(state: EngineState, seed) -> EngineState:
    """The default ensemble ``seed_fn``: add ``seed * 7919`` to every integer
    world field named ``rng`` or ``*_rng`` (the registry's convention for
    in-handler LCG states), wrapping as int32 does, which is the affine jump
    the scenario builders space their per-row streams with. Any int32 is a
    valid LCG state, so the perturbed replica is exact under the oracle with
    the same world; a model with no RNG field gives identical replicas."""
    upd = {}
    for name in state.world._fields:
        if name != "rng" and not name.endswith("_rng"):
            continue
        f = getattr(state.world, name)
        if f.dtype.is_floating_point or f.dtype.is_complex or \
                f.dtype == torch.bool:
            continue
        bits = torch.iinfo(f.dtype).bits
        s = torch.as_tensor(seed, device=f.device).to(torch.int64)
        v = f.to(torch.int64) + s * 7919
        half = 1 << (bits - 1)
        upd[name] = ((v + half) % (1 << bits) - half).to(f.dtype)
    return state._replace(world=state.world._replace(**upd)) if upd else state


def fused_select_xla(time_key, seq, safe, time, kind, src, dst, ctx, payload,
                     valid, table_id, res, free_tail, exec_cap: int, *,
                     n_kinds: int, n_res: int, n_tables: int
                     ) -> tuple[FusedSelect, torch.Tensor]:
    """The stitched twin of the fused front end (the reference's
    ``fused_select_xla``): the plain select, the safe flags, the field
    gathers, ``sync.conflict_mask`` (a sort, where the plain
    ``fused_select`` counts pairs), the plain grouping and the release
    ranks. A drop-in ``fused_fn`` for tests; byte-equal to the kernel."""
    cap = time_key.shape[-1]
    m = max(min(exec_cap, cap), 1)
    exec_idx = _ref.select_events(time_key, seq, m)
    exec_safe = sync.exec_selection_ring(safe, exec_idx)
    rows = ev.gather(ev.EventBatch(time, seq, kind, src, dst, ctx, payload,
                                   valid), exec_idx)
    dirty = sync.conflict_mask(exec_safe, tu.gather_rows(table_id, exec_idx),
                               tu.gather_rows(res, exec_idx), n_res=n_res,
                               n_tables=n_tables)
    clean = exec_safe & ~dirty
    order, _rank, counts = _ref.group_by_kind(rows.kind, clean, n_kinds)
    w = exec_safe.to(I32)
    rel = (free_tail.to(I32)[:, None] + tu.icumsum(w, 1) - w) % cap
    return FusedSelect(exec_idx, exec_safe, *rows[:-1], valid=rows.valid,
                       clean=clean, order=order, rel_pos=rel), counts


class Engine:
    """Binds a built scenario to the superstep program on one device or on
    the shards of a mesh (``run_distributed``).

    ``device=None`` means the CUDA card (a missing card raises); pass
    ``device="cpu"`` to run on the CPU. The hooks default to
    ``kernels.ops``, which launches the CUDA kernels for tensors on the card:
    ``select_fn``/``group_fn``/``route_fn``/``trace_fn`` always, and under
    ``spec.fused_select`` ``fused_fn`` (with ``slot_fn``, unless a
    ``fused_fn`` is given) in place of the select and the grouping.

    The host layer: with a ``trace_stream`` (``monitoring.TraceStream``)
    attached, ``trace_cap`` sizes a per-agent *ring* that the drivers drain
    to the stream at window starts, every ``drain_every`` windows and
    whenever the next window could overrun it, so a run of any length keeps
    ``C_TRACE_DROP == 0``; a ``metrics_stream`` gets the counters at the end
    of its interval windows. A ``checkpointer`` (``checkpoint.
    SimCheckpointer``) saves the state every ``checkpointer.every`` windows,
    then ``window_hook(window, state)`` runs, after every window of
    ``run_local``, ``run_adaptive`` and their twins across devices (with
    the unpadded state). ``step_local`` fires none of them.
    """

    def __init__(self, world, own, init_events: ev.EventBatch,
                 spec: ScenarioSpec, trace_cap: int = 0,
                 select_fn: Callable | None = None,
                 group_fn: Callable | None = None,
                 route_fn: Callable | None = None,
                 trace_fn: Callable | None = None,
                 fused_fn: Callable | None = None,
                 slot_fn: Callable | None = None,
                 device=None,
                 trace_stream: "mon.TraceStream | None" = None,
                 metrics_stream: "mon.MetricsStream | None" = None,
                 drain_every: int = 16,
                 checkpointer=None,
                 window_hook: Callable | None = None):
        self.trace_stream = trace_stream
        self.metrics_stream = metrics_stream
        self.checkpointer = checkpointer
        self.window_hook = window_hook
        self.drain_every = int(drain_every)
        # replicas stacked on the agent dimension (run_ensemble's R)
        self._replicas = 1
        if self.drain_every < 1:
            raise ValueError(f"drain_every must be >= 1, got {drain_every}")
        if trace_stream is not None and trace_cap <= 0:
            raise ValueError(
                "a TraceStream needs a device-side ring: pass trace_cap > 0")
        # host reads of device tensors, the conflict fallback's sequential
        # steps, and the drains' ring copies
        self.host_reads = 0
        self.fallback_steps = 0
        self.drains = 0
        self.drain_bytes = 0
        if spec.merge_mode not in ("delta", "dense"):
            raise ValueError(f"spec.merge_mode must be 'delta' or 'dense', "
                             f"got {spec.merge_mode!r}")
        if spec.insert_mode not in ("ring", "ref"):
            raise ValueError(f"spec.insert_mode must be 'ring' or 'ref', got "
                             f"{spec.insert_mode!r}")
        if not isinstance(spec.fused_select, bool):
            raise ValueError(f"spec.fused_select must be a bool, got "
                             f"{spec.fused_select!r}")
        self.device = resolve_device(device)
        self.registry = registry_of(world)
        self.world = _to(world, self.device)
        self.own = _to(own, self.device)
        self.init_events = _to(init_events, self.device)
        self.spec = spec
        self.trace_cap = trace_cap
        self.select_fn = select_fn or ops.select_events
        self.group_fn = group_fn or functools.partial(
            ops.group_by_kind, n_kinds=self.registry.n_kinds)
        # None: ``ops.route_rank`` over the run's agent ids and the
        # sentinel, ``size + 1`` buckets (the padded D * K + 1 across shards)
        self.route_fn = route_fn
        self.trace_fn = trace_fn or ops.trace_rank
        self.table = self.registry.make_handlers(spec.lookahead,
                                                 spec.work_per_mb)
        self._n_res = self.registry.max_rows(world)
        self._kind_table = torch.tensor(self.registry.kind_table, dtype=I32,
                                        device=self.device)
        # (own, kind table) on each shard's device
        self._consts = {self.device: (self.own, self._kind_table)}
        # fused_fn(time_key, seq, safe, time, kind, src, dst, ctx, payload,
        # valid, table_id, res, free_tail, exec_cap) -> (FusedSelect, the
        # clean lanes' per-kind counts), used only under spec.fused_select;
        # slot_fn(free_ring, free_head, want) -> insert slots, used by the
        # ring insert whenever it is set
        self.fused_fn = fused_fn
        self.slot_fn = slot_fn
        if spec.fused_select and fused_fn is None:
            self.fused_fn = functools.partial(
                ops.fused_select, n_kinds=self.registry.n_kinds,
                n_res=self._n_res)
            if slot_fn is None:
                self.slot_fn = ops.ring_slots

    # ------------------------------------------------------------------ init
    def init_state(self) -> EngineState:
        """Stacked (A, ...) initial state; initial events homed to owners."""
        A, cap, dev = self.spec.n_agents, self.spec.pool_cap, self.device
        init = self.init_events
        owner = self.world.lp_agent[init.dst.clamp(0, self.spec.n_lp - 1)]
        mine = init.valid[None] & (owner[None] == tu.arange(A, dev)[:, None])
        batch = init.map(lambda x: x[None].expand((A,) + x.shape))
        # an empty pool's ring is the identity, so both inserts assign the
        # same ascending slots here
        ins = ev.insert if self.spec.insert_mode == "ring" else ev.insert_ref
        pool, dropped = ins(ev.empty_pool(cap, A, dev),
                            batch._replace(valid=mine))
        world = self.world.__class__(*(
            x[None].expand((A,) + x.shape).contiguous() for x in self.world))
        counters = torch.zeros((A, self.registry.n_counters), dtype=I32,
                               device=dev)
        counters[:, mon.C_DROP_POOL] = dropped
        z = torch.zeros((A,), dtype=I32, device=dev)
        return EngineState(
            world=world, pool=pool, counters=counters, t_now=z.clone(),
            done=torch.zeros((A,), dtype=torch.bool, device=dev),
            windows=z.clone(),
            trace=torch.zeros((A, max(self.trace_cap, 1), 4), dtype=I32,
                              device=dev),
            trace_n=z.clone(), trace_tail=z.clone())

    # ------------------------------------------------------------- superstep
    def _xcap(self, width: int) -> int:
        """A window's selection width: the exec width within the pool."""
        return max(min(int(width), self.spec.pool_cap), 1)

    def _read(self, t: torch.Tensor) -> np.ndarray:
        """One host read of a device tensor (counted)."""
        self.host_reads += 1
        return t.cpu().numpy()

    def _consts_on(self, dev) -> tuple:
        """(own, kind table) on a shard's device, copied there once."""
        c = self._consts.get(dev)
        if c is None:
            c = self._consts[dev] = (_to(self.own, dev),
                                     self._kind_table.to(dev))
        return c

    def _superstep(self, st: EngineState, exec_cap: int | None = None,
                   ring: bool = False) -> EngineState:
        """One conservative window for every agent of a one-device state."""
        return self._step([st], self._local_axes(st), exec_cap, ring)[0]

    def _step(self, shards: list, axes: sh.ShardAxes,
              exec_cap: int | None = None, ring: bool = False) -> list:
        """One window of every shard, in lockstep."""
        return sh.lockstep(axes, [
            self._window(st, axes, s, exec_cap, ring)
            for s, st in enumerate(shards)], self._read)

    def _window(self, st: EngineState, axes: sh.ShardAxes, s: int,
                exec_cap: int | None = None, ring: bool = False):
        """One conservative window of shard ``s``'s rows: a generator that
        yields at the GVT, the host read, the exchange and the owner-wins
        sum (``core/shards.py``) and returns the shard's new state.
        ``exec_cap`` overrides the spec's static width (the adaptive
        drivers' rung); ``ring`` writes the trace as the streaming ring (the
        drain runs before, on the host)."""
        spec = self.spec
        world, pool, counters = st.world, st.pool, st.counters
        xcap = self._xcap(spec.exec_cap if exec_cap is None else exec_cap)
        own, kind_table = self._consts_on(pool.time.device)

        # 1-2. GVT + safe mask; 3. order (time, seq) + compact to the
        # earliest exec_cap slots
        lmin = sync.local_min_per_ctx(pool, spec.n_ctx)
        gvt = yield sh.Min(lmin)
        with record_function("window.select"):
            horizon = sync.horizons(gvt, spec.lookahead, spec.t_end)
            done = sync.all_done(gvt, spec.t_end)
            safe = sync.safe_mask(pool, horizon)
            time_key = torch.where(safe, pool.time, ev.T_INF)
            if spec.fused_select:
                # select + gather + conflict + group + release ranks in one
                # call; the conflict key columns are gathered pool-wide
                tbl_pool = kind_table[pool.kind.clamp(
                    0, self.registry.n_kinds - 1).long()]
                res_pool = tu.gather_rows(world.lp_res,
                                          pool.dst.clamp(0, spec.n_lp - 1))
                fs, counts = self.fused_fn(
                    time_key, pool.seq, safe, pool.time, pool.kind, pool.src,
                    pool.dst, pool.ctx, pool.payload, pool.valid, tbl_pool,
                    res_pool, pool.free_tail, xcap)
                exec_idx, exec_safe = fs.exec_idx, fs.exec_safe
                cand = ev.EventBatch(*fs[2:10])
                pre, rel_pos = (fs.clean, fs.order, counts), fs.rel_pos
            else:
                exec_idx = self.select_fn(time_key, pool.seq, xcap)
                exec_safe = sync.exec_selection_ring(safe, exec_idx)
                cand = ev.gather(pool, exec_idx)
                pre = rel_pos = None

        # 4. execute
        execute = (self._execute_batched if spec.batched_dispatch
                   else self._execute_scan)
        world, counters, emits, trace, trace_n = yield from execute(
            world, counters, cand, exec_safe, st.trace, st.trace_n,
            kind_table, ring=ring, pre=pre)
        if ring:
            # ring overwrite accounting: rows written this window on top of
            # un-drained ones (0 while the drain keeps the ring ahead)
            tcap = st.trace.shape[1]
            over_before = (st.trace_n - st.trace_tail - tcap).clamp(min=0)
            over_after = (trace_n - st.trace_tail - tcap).clamp(min=0)
            counters = mon.bump(counters, mon.C_TRACE_DROP,
                                over_after - over_before)

        with record_function("window.release"):
            n_processed = tu.isum(exec_safe, 1)
            n_spill = tu.isum(safe, 1) - n_processed
            counters = mon.bump(counters, mon.C_EVENTS, n_processed)
            counters = mon.bump(counters, mon.C_EXEC_SPILL, n_spill)
            counters = mon.bump(counters, mon.C_WINDOWS, 1)
            # reclaim: ring mode pushes the executed slots onto the ring's
            # tail; ref mode invalidates them through a pool-wide mask
            if spec.insert_mode == "ring":
                counters = mon.bump(
                    counters, mon.C_RING_WRAP,
                    pool.free_tail + n_processed >= spec.pool_cap)
                pool = ev.release(pool, exec_idx, exec_safe, pos=rel_pos)
            else:
                slot_mask, _ = sync.exec_selection(safe, exec_idx)
                pool = ev.pop_mask_ref(pool, slot_mask)
            # processed LPs drop back to WAITING at window end
            world = world._replace(lp_state=torch.where(world.lp_state == 2,
                                                        3, world.lp_state))

        # 5-6. route + insert
        pool, counters = yield from self._route_and_insert(
            world, pool, counters, emits, axes, s)

        # 7. replicated-state sync over the fleet, then the pool gauges
        if axes.size > 1:
            with record_function("window.sync"):
                plan, parts = self.registry.owner_parts(world, own,
                                                        axes.me(s))
            totals = yield sh.Sum(parts)
            world = self.registry.owner_merge(world, plan, totals)
        with record_function("window.gauges"):
            counters = mon.gauge(counters, mon.C_POOL_OCC, ev.occupancy(pool))
            counters = mon.gauge(counters, mon.C_POOL_FREE, pool.free_count)

        return EngineState(world=world, pool=pool, counters=counters,
                           t_now=torch.amax(horizon, dim=1), done=done,
                           windows=st.windows + 1, trace=trace,
                           trace_n=trace_n, trace_tail=st.trace_tail)

    def _row_events(self, cand: ev.EventBatch, idx: torch.Tensor) -> Ev:
        """One candidate row per agent (``idx`` (A,), clamped) as handler
        lanes, lane ``a`` on agent ``a``: ``Ev.agent`` is a row of the
        stacked state, an ensemble's replicas included (no handler compares
        it with ``lp_agent``)."""
        A, m = cand.time.shape
        a = torch.arange(A, device=idx.device)
        i = idx.clamp(0, m - 1).long()
        return Ev(*(x[a, i] for x in cand[:7]), agent=a.to(I32))

    # ------------------------------------------------- step 4: sequential fold
    def _execute_scan(self, world, counters, cand: ev.EventBatch,
                      exec_safe, trace, trace_n, kind_table, ring=False,
                      pre=None):
        """``batched_dispatch=False``: the rows in (time, seq) order, one at a
        time per agent. Safe rows form a prefix of the selection, so the fold
        stops after the longest agent's safe prefix (one host read); the
        remaining steps of the reference's scan change nothing. ``pre`` (the
        fused front end's conflict mask and grouping) is not needed here. A
        generator, as ``_window``."""
        del pre, kind_table
        A, m = cand.time.shape
        dev = cand.time.device
        ecap = self.spec.emit_cap
        emits = ev.empty_batch((A, ecap + 1), device=dev)
        emit_n = torch.zeros((A,), dtype=I32, device=dev)
        tcap = trace.shape[1]
        a = torch.arange(A, device=dev)
        # one host read: each agent's safe-prefix length and the row kinds
        n_safe = tu.isum(exec_safe, 1)
        host = (yield sh.Read(torch.cat([n_safe, cand.kind.clamp(
            0, self.registry.n_kinds - 1).reshape(-1)]))).tolist()
        n_safe_h, kinds_h = host[:A], host[A:]
        for i in range(max(n_safe_h)):
            is_safe = exec_safe[:, i]
            kinds = {kinds_h[r * m + i] for r in range(A) if i < n_safe_h[r]}
            e = self._row_events(cand, torch.full((A,), i, device=dev))
            world, counters, out = apply_handler(self.table, world, counters,
                                                 e, is_safe, kinds)
            val = out.valid
            pos = emit_n[:, None] + tu.icumsum(val, 1) - 1
            ok = val & (pos < ecap)
            widx = torch.where(ok, pos, ecap).long()
            emits = ev.EventBatch(*(
                x.index_put((a[:, None].expand_as(widx), widx), y)
                for x, y in zip(emits, out._replace(valid=ok))))
            emit_n = emit_n + tu.isum(val, 1)
            counters = mon.bump(counters, mon.C_DROP_POOL,
                                tu.isum(val & ~ok, 1))
            trow = torch.stack([e.time, e.seq, e.kind, e.dst], 1)
            if ring:
                tidx = torch.where(is_safe, trace_n % tcap, tcap)
            else:
                tidx = torch.where(is_safe & (trace_n < tcap), trace_n, tcap)
                if self.trace_cap > 0:
                    counters = mon.bump(
                        counters, mon.C_TRACE_DROP,
                        (is_safe & (trace_n >= tcap)).to(I32))
            trace = tu.scatter_rows(trace, tidx[:, None], trow[:, None])
            trace_n = trace_n + is_safe.to(I32)
        emits = emits.map(lambda x: x[:, :ecap])
        return world, counters, emits, trace, trace_n

    # -------------------------------------------- step 4: vectorized dispatch
    def _execute_batched(self, world, counters, cand: ev.EventBatch,
                         exec_safe, trace, trace_n, kind_table, ring=False,
                         pre=None):
        """Grouped batched dispatch: conflict-free rows in one handler
        evaluation, conflicted rows through a sequential fold compacted to
        them. Emits land in a per-row (m, MAX_EMIT) matrix and the trace is
        written in window order, so the result equals the sequential fold.
        ``pre = (clean, order, counts)`` comes from the fused front end. A
        generator, as ``_window``."""
        spec = self.spec
        A, xcap = cand.time.shape
        dev = cand.time.device
        nk = self.registry.n_kinds

        if pre is None:
            table_id = kind_table[cand.kind.clamp(0, nk - 1).long()]
            res = tu.gather_rows(world.lp_res,
                                 cand.dst.clamp(0, spec.n_lp - 1))
            dirty = sync.conflict_mask(exec_safe, table_id, res,
                                       n_res=self._n_res,
                                       n_tables=self.registry.n_tables)
            clean = exec_safe & ~dirty
            # group the clean rows by kind (group_fn kernel)
            with record_function("execute.group"):
                order, _rank, counts = self.group_fn(cand.kind, clean)
        else:
            # clean == exec_safe & ~dirty with dirty inside exec_safe
            clean, order, counts = pre
            dirty = exec_safe & ~clean
        present = counts.amax(0)
        # the conflicted rows in window order for the fallback
        n_dirty = tu.isum(dirty, 1)
        pos = tu.arange(xcap, dev)[None]
        dpos = torch.sort(torch.where(dirty, pos, xcap), dim=1).values
        dkind = torch.gather(cand.kind.clamp(0, nk - 1), 1,
                             dpos.clamp(max=xcap - 1).long())
        # the window's one host read besides `done`: which kinds the clean
        # rows hold (handlers of absent kinds are not evaluated), and the
        # fallback's trip count and row kinds
        host = (yield sh.Read(
            torch.cat([present, n_dirty, dkind.reshape(-1)]))).tolist()
        clean_kinds = {k for k in range(nk) if host[k] > 0}
        n_dirty_h, dkind_h = host[nk:nk + A], host[nk + A:]

        # batched phase over the grouped rows
        order_l = order.long()
        rows_g = ev.gather(cand, order_l)
        clean_g = torch.gather(clean, 1, order_l)
        batch_fn = (apply_handler_batch if spec.merge_mode == "delta"
                    else apply_handler_batch_dense)
        with record_function("execute.batched"):
            world, cdelta, emits_g = batch_fn(self.table, world, rows_g,
                                              clean_g, clean_kinds)
        counters = counters + cdelta
        counters = mon.bump(counters, mon.C_BATCH_EXEC, tu.isum(clean, 1))

        # per-row emit matrix in window order (grouped lanes scattered back)
        a_idx = torch.arange(A, device=dev)[:, None].expand(A, xcap)
        emit_mat = emits_g.map(
            lambda x: torch.zeros_like(x).index_put((a_idx, order_l), x))

        # conflict fallback: sequential fold over each agent's dirty rows
        counters = mon.bump(counters, mon.C_BATCH_FALLBACK, n_dirty)
        a = torch.arange(A, device=dev)
        self.fallback_steps += max(n_dirty_h)
        for k in range(max(n_dirty_h)):
            p = dpos[:, k]
            active = k < n_dirty
            kinds = {dkind_h[r * xcap + k] for r in range(A)
                     if k < n_dirty_h[r]}
            e = self._row_events(cand, p)
            with record_function("execute.fallback"):
                world, counters, out = apply_handler(
                    self.table, world, counters, e, active, kinds)
            # agents past their dirty rows write the spare column xcap
            emit_mat = ev.EventBatch(*(
                torch.cat([x, x[:, :1]], 1).index_put((a, p.long()), y)[
                    :, :xcap]
                for x, y in zip(emit_mat, out)))

        # trace in (time, seq) window order (trace_fn kernel)
        rows4 = torch.stack([cand.time, cand.seq, cand.kind, cand.dst], 2)
        with record_function("execute.trace"):
            trace, trace_n, clipped = ev.trace_append(
                trace, trace_n, rows4, exec_safe, ring=ring,
                rank_fn=self.trace_fn)
        if not ring and self.trace_cap > 0:
            counters = mon.bump(counters, mon.C_TRACE_DROP, clipped)

        # flatten the per-row matrix row-major (the sequential append order)
        flat = emit_mat.map(
            lambda x: x.reshape((A, xcap * ev.MAX_EMIT) + x.shape[3:]))
        emits, _n_emit, dropped = ev.compact_batch(flat, spec.emit_cap)
        counters = mon.bump(counters, mon.C_DROP_POOL, dropped)
        return world, counters, emits, trace, trace_n

    # ---------------------------------------------------------------- routing
    def _insert(self, pool: ev.EventPool, counters, batch: ev.EventBatch):
        """The spec's insert: the ring (through ``slot_fn`` when set) with
        its head-wrap accounting, or the reference rank scan."""
        if self.spec.insert_mode == "ref":
            pool2, dropped = ev.insert_ref(pool, batch)
            return pool2, counters, dropped
        pool2, dropped = ev.insert(pool, batch, slot_fn=self.slot_fn)
        n_take = pool.free_count - pool2.free_count
        counters = mon.bump(counters, mon.C_RING_WRAP,
                            pool.free_head + n_take >= self.spec.pool_cap)
        return pool2, counters, dropped

    def _route_and_insert(self, world, pool: ev.EventPool, counters,
                          emits: ev.EventBatch, axes: sh.ShardAxes, s: int,
                          migrate: bool = False):
        """Route emits by destination agent and insert (steps 5-6): a
        generator over shard ``s``'s rows, as ``_window``. Every row scatters
        its emits into a (size * route_cap) send buffer by destination, the
        exchange (``shards.Exchange``, the reference's ``all_to_all``)
        hands agent d every source's block d in ascending source order, and
        the receivers insert. ``size`` is the fleet's agent count, padded
        to D * K across shards, so the sentinel of invalid rows and the
        bucket count of ``route_rank`` cover the pad agents' ids.

        ``migrate`` is the placement migration's flavour: rows shipped to
        another agent are booked in ``C_MIGRATE_OUT`` (after the route cap)
        and rows received in ``C_MIGRATE_IN`` (before the insert), so the
        two sum to the same total; a receiver's overflow is ``C_DROP_POOL``.
        An ensemble exchanges within each replica."""
        spec = self.spec
        n = axes.size
        if n == 1:
            with record_function("window.insert"):
                pool, counters, dropped = self._insert(pool, counters, emits)
                counters = mon.bump(counters, mon.C_DROP_POOL, dropped)
                counters = mon.bump(counters, mon.C_LP_LOCAL,
                                    tu.isum(emits.valid, 1))
            return pool, counters

        with record_function("window.route"):
            dev = emits.time.device
            me = axes.me(s)[:, None]
            rcap = spec.route_cap
            dst_agent = torch.where(
                emits.valid,
                tu.gather_rows(world.lp_agent,
                               emits.dst.clamp(0, spec.n_lp - 1)), n)
            rank = (ops.route_rank(dst_agent, n_buckets=n + 1)
                    if self.route_fn is None else self.route_fn(dst_agent))

            ok = emits.valid & (rank < rcap)
            counters = mon.bump(counters, mon.C_DROP_ROUTE,
                                tu.isum(emits.valid & ~ok, 1))
            counters = mon.bump(counters, mon.C_MSGS_REMOTE,
                                tu.isum(ok & (dst_agent != me), 1))
            counters = mon.bump(counters, mon.C_LP_LOCAL,
                                tu.isum(ok & (dst_agent == me), 1))
            if migrate:
                counters = mon.bump(counters, mon.C_MIGRATE_OUT,
                                    tu.isum(ok & (dst_agent != me), 1))
            flat = torch.where(ok, dst_agent * rcap + rank, n * rcap)
            # each row's send buffer (size * route_cap): block d for agent d
            fills = (ev.T_INF, 0, 0, 0, 0, 0, 0.0, False)
            rows = emits.time.shape[0]
            bufs = [torch.full((rows, n * rcap) + col.shape[2:], fill,
                               dtype=col.dtype, device=dev)
                    for col, fill in zip(emits, fills)]
            sent = tu.scatter_rows_many(bufs, flat, list(emits))
        rx = ev.EventBatch(*(yield sh.Exchange(sent, rcap)))
        with record_function("window.insert"):
            if migrate:
                counters = mon.bump(counters, mon.C_MIGRATE_IN,
                                    tu.isum(rx.valid, 1))
            pool, counters, dropped = self._insert(pool, counters, rx)
            counters = mon.bump(counters, mon.C_DROP_POOL, dropped)
        return pool, counters

    # -------------------------------------------------------------- migration
    def _placement(self, st: EngineState, new_lp_agent, axes: sh.ShardAxes,
                   s: int):
        """Shard ``s``'s part of a placement change (a generator, as
        ``_window``): every row takes the fleet-wide ``lp_agent``; then, in
        a fleet of more than one agent, each row extracts the pending events
        whose LP it no longer owns, ``pop_mask`` canonicalizes its free
        ring, and they travel the routing path with ``migrate=True``."""
        dev = st.t_now.device
        la = torch.as_tensor(new_lp_agent, dtype=I32, device=dev)
        world = st.world._replace(lp_agent=la[None].expand(
            st.t_now.shape[0], la.shape[0]).contiguous())
        if self.spec.n_agents == 1:
            return st._replace(world=world)
        pool = st.pool
        owner = tu.gather_rows(world.lp_agent,
                               pool.dst.clamp(0, self.spec.n_lp - 1))
        moving = pool.valid & (owner != axes.me(s)[:, None])
        emits = ev.extract(pool, moving)
        pool = ev.pop_mask(pool, moving)
        pool, counters = yield from self._route_and_insert(
            world, pool, st.counters, emits, axes, s, migrate=True)
        return st._replace(world=world, pool=pool, counters=counters)

    def apply_placement_local(self, st: EngineState,
                              new_lp_agent) -> EngineState:
        """Move LPs to a new placement (paper §4.1, dynamic decomposition).

        Component state is replicated, so migration rewrites ``lp_agent``
        (fleet-wide, (n_lp,)) and re-homes the pending events whose LP
        moved through the routing path (the ``route_rank`` kernel over the
        whole pool), booked in ``C_MIGRATE_OUT``/``C_MIGRATE_IN``."""
        axes = self._local_axes(st)
        return sh.lockstep(axes, [self._placement(st, new_lp_agent, axes, 0)],
                           self._read)[0]

    def apply_placement_distributed(self, st: EngineState, new_lp_agent,
                                    mesh) -> EngineState:
        """:meth:`apply_placement_local` across the shards of ``mesh``: the
        unpadded (A, ...) ``st`` is padded and split, every shard ships its
        moving events through the exchange, and the unpadded result equals
        ``apply_placement_local``'s on the same state byte for byte."""
        axes = self._dist_axes(mesh)
        shards = self._split(self._pad_state(st, axes.size), axes)
        out = sh.lockstep(axes, [
            self._placement(x, new_lp_agent, axes, s)
            for s, x in enumerate(shards)], self._read)
        return self._slice_state(self._join(out))

    # ----------------------------------------------------------------- shards
    def _local_axes(self, st: EngineState) -> sh.ShardAxes:
        """One shard holding every row of ``st`` (an ensemble's replicas
        grouped)."""
        return sh.ShardAxes((st.t_now.device,), st.t_now.shape[0],
                            self._replicas)

    def _dist_axes(self, mesh) -> sh.ShardAxes:
        """The packing of ``mesh`` (a list of devices, one a shard): ``K =
        ceil(A / D)`` agents a shard, the state padded to D * K rows."""
        devices = tuple(resolve_device(d) for d in mesh)
        if not devices:
            raise ValueError("the drivers across devices need a mesh of at "
                             "least one device")
        k = -(-self.spec.n_agents // len(devices))
        return sh.ShardAxes(devices, k)

    def _pad_state(self, st: EngineState, a_pad: int) -> EngineState:
        """Pad a stacked (A, ...) state to ``a_pad`` rows with inert agents.

        A pad agent's pool is empty, so it adds T_INF to the GVT; its
        ``lp_agent`` row is agent 0's, which names only real agents, so it
        owns no LP and contributes only zeros to the owner-wins sync and
        never receives an event. The uniform fields (the replicated world,
        ``t_now``, ``done``, ``windows``) are broadcast from row 0, so a
        state resumed mid-run stays uniform; counters and trace are zeroed
        (the pad rows are sliced off every result, and all-zero rows leave
        the adaptive stats' maxima as they are)."""
        n = a_pad - st.t_now.shape[0]
        if n == 0:
            return st
        dev = st.t_now.device

        def rep0(x):
            return torch.cat([x, x[:1].expand((n,) + x.shape[1:])])

        def zero(x):
            return torch.cat([x, x.new_zeros((n,) + x.shape[1:])])

        epool = ev.empty_pool(self.spec.pool_cap, n, dev)
        return EngineState(
            world=type(st.world)(*map(rep0, st.world)),
            pool=type(st.pool)(*(torch.cat([x, e])
                                 for x, e in zip(st.pool, epool))),
            counters=zero(st.counters), t_now=rep0(st.t_now),
            done=rep0(st.done), windows=rep0(st.windows),
            trace=zero(st.trace), trace_n=zero(st.trace_n),
            trace_tail=zero(st.trace_tail))

    def _slice_state(self, st: EngineState) -> EngineState:
        """Drop the pad agents' rows: the real agents' (A, ...) state."""
        A = self.spec.n_agents
        if st.t_now.shape[0] == A:
            return st
        return map_state(lambda x: x[:A], st)

    def _split(self, st: EngineState, axes: sh.ShardAxes) -> list:
        """A padded (D * K, ...) state as D shard states, each a copy on
        its shard's device."""
        k = axes.n_lanes
        return [map_state(lambda x: x[s * k:(s + 1) * k].to(dev, copy=True),
                          st) for s, dev in enumerate(axes.devices)]

    def _join(self, shards: list) -> EngineState:
        """The shard states stacked shard-major on the first one's device."""
        if len(shards) == 1:
            return shards[0]
        dev = shards[0].t_now.device
        return map_state(lambda *xs: torch.cat([x.to(dev) for x in xs]),
                         *shards)

    def _rows(self, shards: list, fn) -> torch.Tensor:
        """``fn(shard state)`` of every shard, stacked on the first one's
        device (the host reads of the drivers)."""
        if len(shards) == 1:
            return fn(shards[0])
        dev = shards[0].t_now.device
        return torch.cat([fn(st).to(dev) for st in shards])

    # ------------------------------------------------------------ host layer
    @property
    def _streaming(self) -> bool:
        return self.trace_stream is not None or self.metrics_stream is not None

    @property
    def _checkpointing(self) -> bool:
        return self.checkpointer is not None and self.checkpointer.every > 0

    def _begin_streams(self, widths) -> None:
        """Arm the attached streams for a run at exec widths ``widths``: the
        ring must hold the widest window's writes."""
        if self.trace_stream is not None:
            need = max(self._xcap(w) for w in widths)
            if self.trace_cap < need:
                raise ValueError(
                    f"streaming trace ring too small: trace_cap="
                    f"{self.trace_cap} must hold one window's writes (max "
                    f"exec width {need}) or the drain cannot keep "
                    f"C_TRACE_DROP == 0")
            self.trace_stream.begin(self.spec.n_agents)
        if self.metrics_stream is not None:
            self.metrics_stream.begin(self.spec.n_agents, self.registry)

    def _finalize_streams(self, st: EngineState) -> EngineState:
        """Flush the never-drained tail spans and the final metrics record
        out of the finished (unpadded) state."""
        if self.trace_stream is not None:
            self.trace_stream.finalize(st.trace.cpu().numpy(),
                                       st.trace_n.cpu().numpy(),
                                       st.trace_tail.cpu().numpy())
        if self.metrics_stream is not None:
            self.metrics_stream.finalize(st.counters.cpu().numpy(),
                                         st.windows.cpu().numpy(),
                                         st.t_now.cpu().numpy())
        return st

    def _start(self, shards: list, widths, max_windows: int, hosted: bool):
        """Arm a run: the streams, then one host read of the window count
        (and, with a trace stream, every row's ``trace_tail``, which the
        host mirrors from here on). Returns (window limit, tail):
        ``max_windows`` counts all windows under the plain driver and this
        call's under the host layer, as in the reference."""
        self._begin_streams(widths)
        parts = [shards[0].windows[:1]]
        if self.trace_stream is not None:
            parts.append(self._rows(shards, lambda st: st.trace_tail))
        host = self._read(torch.cat(parts)).tolist()
        limit = host[0] + max_windows if hosted else max_windows
        return limit, (host[1:] if self.trace_stream is not None else None)

    def _window_start(self, shards: list, limit: int, tail, xcap: int):
        """The host read before a window: ``done``, the window count (both
        uniform, read off the first row) and, with a trace stream, every
        row's ``trace_n``, then the drain. Returns (shards, window index or
        None at the end, tail)."""
        st0 = shards[0]
        parts = [st0.done[:1].to(I32), st0.windows[:1]]
        if self.trace_stream is not None:
            parts.append(self._rows(shards, lambda st: st.trace_n))
        host = self._read(torch.cat(parts)).tolist()
        done, windows = bool(host[0]), host[1]
        if done or windows >= limit:
            return shards, None, tail
        if self.trace_stream is not None:
            shards, tail = self._drain(shards, windows, host[2:], tail, xcap)
        return shards, windows, tail

    def _drain(self, shards: list, windows: int, trace_n: list, tail: list,
               xcap: int):
        """The window-start drain (before this window's writes): ship each
        row's span ``[trace_tail, trace_n)`` when the cadence hits or when
        this window's widest write could overrun the ring, then move
        ``trace_tail`` to ``trace_n`` there. The rings are copied to the
        host (one read for all shards, merged shard-major) only when some
        span is not empty; a pad agent's span always is. ``tail`` is the
        host's mirror of ``trace_tail``."""
        tcap = shards[0].trace.shape[1]
        cadence = windows % self.drain_every == 0
        pending = [n - t for n, t in zip(trace_n, tail)]
        do = [cadence or p + xcap > tcap for p in pending]
        count = [p if d else 0 for p, d in zip(pending, do)]
        if any(c > 0 for c in count):
            ring = self._read(self._rows(shards, lambda st: st.trace))
            self.drains += 1
            self.drain_bytes += ring.nbytes
            self.trace_stream.on_drain(np.arange(len(tail)), np.array(tail),
                                       np.array(count), ring)
        new_tail = [n if d else t for n, t, d in zip(trace_n, tail, do)]
        if new_tail != tail:
            k = len(tail) // len(shards)
            shards = [st._replace(trace_tail=torch.tensor(
                new_tail[s * k:(s + 1) * k], dtype=I32,
                device=st.trace_tail.device)) for s, st in enumerate(shards)]
        return shards, new_tail

    def _window_end(self, shards: list, window: int, rung=None,
                    host_counters=None) -> None:
        """After a window: the metrics record (the counters read only on
        the stream's interval windows, unless the caller read them; pad
        agents' rows are ignored), the due checkpoint of the unpadded
        state, then the window hook with that state."""
        ms = self.metrics_stream
        if ms is not None and window % ms.interval == 0:
            host = host_counters
            if host is None:
                host = self._read(self._rows(shards, lambda st: torch.cat(
                    [st.t_now[:, None], st.counters], 1)))
            n = host.shape[0]
            ms.on_window(np.arange(n), np.full(n, window), host[:, 0],
                         host[:, 1:])
        ck = self.checkpointer
        due = ck is not None and ck.due(window)
        if not due and self.window_hook is None:
            return
        st = self._slice_state(self._join(shards))
        if due:
            ck.save_sim(window, st, engine=self, rung=rung)
        if self.window_hook is not None:
            self.window_hook(window, st)

    def restore(self, step: int | None = None):
        """Load a checkpoint of this engine's checkpointer: returns a
        ``SimCheckpoint(step, state, rung)`` for a driver's ``state=`` (and
        ``rung=``), and stages its trace spans and metrics records in the
        attached streams. The state is unpadded, so any driver resumes it,
        on any number of shards."""
        if self.checkpointer is None:
            raise ValueError("no checkpointer attached to this engine")
        return self.checkpointer.restore_sim(self, step=step)

    def _drive(self, shards: list, axes: sh.ShardAxes, max_windows: int,
               hosted: bool, policy: "pol.ExecPolicy | None" = None,
               rung: int | None = None) -> list:
        """The host-stepped window loop of ``run_local``,
        ``run_distributed`` and their adaptive twins, over one state a
        shard. Each window: the host read of ``done`` (and the drain), the
        shards' window in lockstep, then, under a ``policy``, one read of
        every row's counters and the next rung, the hottest shard's
        (``policy.choose_rung_lockstep``; one shard is ``run_adaptive``'s
        ``choose_rung``), then the metrics, the checkpoint and the hook."""
        ring = self.trace_stream is not None
        widths = [self.spec.exec_cap] if policy is None else policy.ladder
        limit, tail = self._start(shards, widths, max_windows, hosted)
        if policy is not None:
            rung = policy.init_rung if rung is None else int(rung)
            prev = self._read(self._rows(shards, lambda st: st.counters))
            rungs: list[int] = []
        while True:
            width = widths[0] if policy is None else widths[rung]
            shards, w, tail = self._window_start(shards, limit, tail,
                                                 self._xcap(width))
            if w is None:
                break
            host = None
            if policy is not None:
                rungs.append(rung)
            shards = self._step(shards, axes, exec_cap=width, ring=ring)
            if policy is not None:
                # the window's one read of the counters, with t_now for the
                # metrics record
                host = self._read(self._rows(shards, lambda st: torch.cat(
                    [st.t_now[:, None], st.counters], 1)))
                cur = host[:, 1:]
                rung = pol.choose_rung_lockstep(
                    policy, rung, pol.shard_window_stats(
                        prev, cur, self.spec.pool_cap, axes.n_shards))
                prev = cur
            self._window_end(shards, w + 1, rung=rung, host_counters=host)
        if policy is not None:
            self.adaptive_rungs = tuple(rungs)
        return shards

    # ------------------------------------------------------------------- run
    def step_local(self, st: EngineState) -> EngineState:
        """One conservative window for every agent."""
        return self._superstep(st)

    def run_local(self, max_windows: int = 10_000,
                  state: EngineState | None = None) -> EngineState:
        """Step windows from the host until ``done`` (computed at the start
        of a window, from the GVT before execution, exactly as the
        reference's ``while_loop`` test) or ``max_windows``, with the host
        layer (streams, checkpoints, the window hook) at each boundary."""
        st = self.init_state() if state is None else state
        hosted = self._streaming or self._checkpointing
        out = self._drive([st], self._local_axes(st), max_windows, hosted)
        return self._finalize_streams(out[0])

    def run_adaptive(self, max_windows: int = 10_000,
                     policy: "pol.ExecPolicy | int | None" = None,
                     state: EngineState | None = None,
                     rung: int | None = None) -> EngineState:
        """Monitoring-driven execution width (``core/policy.py``): each
        window runs at the current ladder rung's width, then the host reads
        the window's counters once and picks the next rung. Spilling is
        oracle-exact for any width sequence, so the trace and world equal
        the static drivers' and the oracle's; only the window count changes.
        The rung trajectory lands in ``self.adaptive_rungs``.

        ``policy`` overrides ``spec.exec_policy`` (a bare int is a one-rung
        ladder: the static run). ``state`` resumes from an earlier state and
        ``rung`` from an earlier rung; at most ``max_windows`` windows run in
        this call, as in the reference."""
        p = pol.normalize(self.spec.exec_policy if policy is None else policy)
        st = self.init_state() if state is None else state
        out = self._drive([st], self._local_axes(st), max_windows, True,
                          policy=p, rung=rung)
        return self._finalize_streams(out[0])

    def run_distributed(self, mesh, max_windows: int = 10_000,
                        state: EngineState | None = None) -> EngineState:
        """The run across the shards of ``mesh`` (a list of torch devices,
        one a shard; ``launch.mesh.make_sim_mesh``), the counterpart of the
        reference's ``shard_map`` x ``vmap`` driver.

        ``K = ceil(A / D)`` agents go to each of the D shards, the state
        padded to D * K rows with inert agents. Every shard runs the window
        on its own (K, ...) state and launches its own kernels at K rows;
        the GVT, the routing exchange and the owner-wins sync are the
        collectives between them (``core/shards.py``), the exchange's
        receive order ascending global source agent, so the result equals
        ``run_local``'s byte for byte, pool slot layouts included, wherever
        the reference's own two drivers agree. A shard of one lane sums its
        flows in the one-lane order, as the reference's dropped size-1 vmap
        does. ``state`` resumes from an unpadded state, on any D; the result
        is unpadded. With streams or a checkpointer attached the host layer
        runs as in ``run_local``: the rings drain shard-major into
        ``merged_engine_trace``'s order, and checkpoints hold the unpadded
        state."""
        axes = self._dist_axes(mesh)
        st = self._pad_state(self.init_state() if state is None else state,
                             axes.size)
        hosted = self._streaming or self._checkpointing
        out = self._drive(self._split(st, axes), axes, max_windows, hosted)
        return self._finalize_streams(self._slice_state(self._join(out)))

    def run_distributed_adaptive(self, mesh, max_windows: int = 10_000,
                                 policy: "pol.ExecPolicy | int | None" = None,
                                 state: EngineState | None = None,
                                 rung: int | None = None) -> EngineState:
        """``run_adaptive`` across the shards of ``mesh``: every shard runs
        the window at the fleet's rung, the host reads every row's counters
        once a window, decides a rung a shard and takes the largest
        (``policy.choose_rung_lockstep``), so the rung trajectory equals
        ``run_adaptive``'s. ``state`` and ``rung`` resume from a checkpoint,
        on any D."""
        p = pol.normalize(self.spec.exec_policy if policy is None else policy)
        axes = self._dist_axes(mesh)
        st = self._pad_state(self.init_state() if state is None else state,
                             axes.size)
        out = self._drive(self._split(st, axes), axes, max_windows, True,
                          policy=p, rung=rung)
        return self._finalize_streams(self._slice_state(self._join(out)))

    # ------------------------------------------------------- ensemble driver
    def ensemble_state(self, seeds, seed_fn: Callable | None = None
                       ) -> EngineState:
        """The (R * A, ...) initial state of an ensemble: replica r is
        ``seed_fn(init_state(), seeds[r])`` (default
        :func:`seed_rng_fields`), stacked replica by replica."""
        seeds = np.asarray(seeds).astype(np.int32).reshape(-1)
        sfn = seed_fn or seed_rng_fields
        base = self.init_state()
        seeds_dev = torch.as_tensor(seeds, device=self.device)
        reps = [sfn(base, seeds_dev[r]) for r in range(seeds.shape[0])]
        return map_state(lambda *xs: torch.stack(xs).reshape(
            (-1,) + xs[0].shape[1:]), *reps)

    def run_ensemble(self, seeds, max_windows: int = 10_000,
                     seed_fn: Callable | None = None) -> EngineState:
        """Monte Carlo over seeds: R replicas of the initial state, replica
        r perturbed by ``seed_fn(state, seeds[r])`` (default
        :func:`seed_rng_fields`), run as one fleet of R * A rows, so each
        kernel launches once a window for all replicas. A replica stops at
        its own end: rows of a done replica (or one at ``max_windows``) keep
        the state they had, as the reference's batched ``while_loop``
        selects them, so replica r's slice of the (R, A, ...) result equals
        a ``run_local`` of its seeded state byte for byte. The host reads
        every replica's ``done`` and window count once a window, and the
        fallback's counts once, as ``run_local`` does. With a
        ``metrics_stream``, the per-replica counter totals land in it
        (``MetricsStream.ensemble``)."""
        if self.trace_stream is not None:
            raise ValueError(
                "run_ensemble cannot stream traces (io_callback is "
                "unsupported under the nested replica vmap); use a bounded "
                "trace_cap for per-replica traces")
        if self._checkpointing:
            raise ValueError(
                "run_ensemble is one fused program with no window "
                "boundaries on the host; checkpoint cadence applies to the "
                "single-run drivers")
        seeds = np.asarray(seeds).astype(np.int32).reshape(-1)
        R, A = seeds.shape[0], self.spec.n_agents
        st = self.ensemble_state(seeds, seed_fn)
        self._replicas = R
        try:
            with ops.lane_groups(R):
                while True:
                    host = self._read(torch.cat([st.done[::A].to(I32),
                                                 st.windows[::A]]))
                    active = (host[:R] == 0) & (host[R:] < max_windows)
                    if not active.any():
                        break
                    new = self._superstep(st)
                    if active.all():
                        st = new
                    else:
                        keep = torch.as_tensor(np.repeat(active, A),
                                               device=self.device)
                        st = map_state(lambda n, o: torch.where(
                            keep.reshape((-1,) + (1,) * (n.ndim - 1)), n, o),
                            new, st)
        finally:
            self._replicas = 1
        out = map_state(lambda x: x.reshape((R, A) + x.shape[1:]), st)
        ms = self.metrics_stream
        if ms is not None:
            ms.begin(A, self.registry)
            ms.ensemble(seeds, out.counters.cpu().numpy(),
                        out.windows.cpu().numpy(), out.t_now.cpu().numpy())
        return out
