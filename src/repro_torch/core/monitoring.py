"""Per-agent monitoring counters and the host streams (counterpart of
``repro.core.monitoring``).

Counters are an int32 vector per agent, (A, n_counters) in the engine state.
Handlers bump per-lane increment vectors of shape (B, n_counters).

The host-streaming layer (paper §4.1's LISA coupling): :class:`TraceStream`
receives the spans the engine drains from its per-agent trace ring at window
boundaries, and :class:`MetricsStream` turns the per-window counter vectors
into periodic JSON-lines snapshots named by the registry's counter table.
The reference ships both through ``io_callback``; the port's window loop is
stepped from the host, so the engine calls them directly.
"""
from __future__ import annotations

import json

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

# Booked on the host by a fleet orchestrator (MetricsStream.book), never in
# the engine: a resumed state stays byte-identical to the uninterrupted one.
FLEET_COUNTERS = (C_PREEMPT, C_RESUME, C_RESHARD)

# Overwritten (not accumulated) every window.
GAUGE_COUNTERS = (C_POOL_OCC, C_POOL_FREE)

# The only counters allowed to differ between the ring insert and the
# reference rank-scan insert of one scenario.
POOL_DIAG_COUNTERS = (C_RING_WRAP,)

# The only counters allowed to differ between the batched and the sequential
# execution of one scenario.
BATCH_DIAG_COUNTERS = (C_BATCH_EXEC, C_BATCH_FALLBACK, C_BATCH_ROWS)

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


def gather_counters(counters: torch.Tensor) -> torch.Tensor:
    """The (A, n) fleet view the scheduler reads. The port keeps every
    agent's counters in one (A, n) tensor on one device, so this is the
    tensor itself (the reference gathers over its agent axis)."""
    return counters


def performance_value(counters: torch.Tensor, n_owned_lps: torch.Tensor,
                      pool_occupancy: torch.Tensor) -> torch.Tensor:
    """The performance value each agent publishes (paper §4.1; higher is
    worse), float32 over (..., n) counters: events per window (CPU load),
    4 x the remote-message ratio (network load), 0.5 x the LPs hosted and
    2 x the pool occupancy (agent load), summed left to right as the
    reference does."""
    c = counters.to(torch.float32)
    windows = torch.clamp(c[..., C_WINDOWS], min=1.0)
    events_per_window = c[..., C_EVENTS] / windows
    remote_ratio = c[..., C_MSGS_REMOTE] / torch.clamp(c[..., C_EVENTS],
                                                       min=1.0)
    return (events_per_window
            + 4.0 * remote_ratio
            + 0.5 * n_owned_lps.to(torch.float32)
            + 2.0 * pool_occupancy.to(torch.float32))


# ------------------------------------------------------- host-streaming layer
def counter_class(idx: int) -> str:
    """The class of a builtin counter index: how a fleet snapshot reads it
    (``gauge`` is a per-window level, the rest accumulate) and which
    equivalence contracts exempt it (``pool-diag``, ``batch-diag``)."""
    if idx in GAUGE_COUNTERS:
        return "gauge"
    if idx in DROP_COUNTERS:
        return "drop"
    if idx in POOL_DIAG_COUNTERS:
        return "pool-diag"
    if idx in BATCH_DIAG_COUNTERS:
        return "batch-diag"
    if idx in FLEET_COUNTERS:
        return "fleet"
    return "counter"


class TraceStream:
    """Host sink of the engine's trace-ring drain.

    The engine appends processed-event rows ``(time, seq, kind, dst)`` to a
    per-agent ring of ``trace_cap`` rows and, at window boundaries, hands
    the un-drained span ``[tail, trace_n)`` of each agent to
    :meth:`on_drain`, tagged with the agent and the span start. Spans key on
    ``(agent, start)``, so a replayed span is a no-op, and reassembly checks
    that they cover ``[0, trace_n)`` contiguously. ``merged()`` is
    ``oracle.merged_engine_trace``'s list, equal to the sequential oracle's
    whenever ``C_TRACE_DROP == 0``.
    """

    def __init__(self):
        self._segments: dict[int, dict[int, np.ndarray]] = {}
        self._trace_n: np.ndarray | None = None
        self._resume: dict[int, dict[int, np.ndarray]] | None = None

    def begin(self, n_agents: int) -> None:
        """Reset for a run of ``n_agents`` (the engine calls this). Spans
        staged by :meth:`load_state` seed the segment map: a resumed run
        drains only ``[trace_tail, ...)``, so the prefix comes from the
        checkpoint."""
        self.n_agents = n_agents
        self._segments = self._resume if self._resume is not None else {}
        self._resume = None
        self._trace_n = None

    # --------------------------------------------------- checkpoint support
    def state_dict(self) -> dict[str, np.ndarray]:
        """Drained spans as flat arrays keyed ``"<agent>/<start>"`` (what
        ``SimCheckpointer`` saves beside the engine state)."""
        return {f"{a}/{start}": seg
                for a, spans in self._segments.items()
                for start, seg in spans.items()}

    def load_state(self, segments: dict[str, np.ndarray]) -> None:
        """Stage checkpointed spans for the next ``begin()``."""
        staged: dict[int, dict[int, np.ndarray]] = {}
        for key, seg in segments.items():
            a, start = key.split("/")
            staged.setdefault(int(a), {})[int(start)] = np.asarray(seg)
        self._resume = staged

    def on_drain(self, agent, start, count, ring) -> None:
        """One drained span of one agent's raw (cap, 4) ring, rows taken
        from positions ``(start + i) % cap``; arrays over agents are
        unrolled lane by lane. A ``count`` of 0 is a no-op."""
        agent = np.asarray(agent)
        if agent.ndim:
            for i in range(agent.shape[0]):
                self.on_drain(agent[i], np.asarray(start)[i],
                              np.asarray(count)[i], np.asarray(ring)[i])
            return
        n = int(count)
        if n <= 0:
            return
        ring = np.asarray(ring)
        idx = (int(start) + np.arange(n)) % ring.shape[0]
        self._segments.setdefault(int(agent), {})[int(start)] = ring[idx].copy()

    def finalize(self, trace, trace_n, trace_tail) -> None:
        """Flush the never-drained tail spans out of a finished state and
        record the per-agent row counts (numpy arrays)."""
        trace = np.asarray(trace)
        self._trace_n = np.asarray(trace_n).copy()
        tail = np.asarray(trace_tail)
        for a in range(trace.shape[0]):
            n = int(self._trace_n[a]) - int(tail[a])
            if n > 0:
                idx = (int(tail[a]) + np.arange(n)) % trace.shape[1]
                self._segments.setdefault(a, {})[int(tail[a])] = (
                    trace[a, idx].copy())

    @property
    def n_streamed(self) -> int:
        """Rows streamed in all (after ``finalize``)."""
        if self._trace_n is None:
            raise RuntimeError("TraceStream not finalized — run the engine "
                               "with the stream attached first")
        return int(self._trace_n.sum())

    def agent_rows(self, agent: int) -> np.ndarray:
        """The agent's whole (trace_n, 4) trace from its spans; raises if
        they do not cover ``[0, trace_n)`` contiguously (a lost span, or an
        overwritten one, which ``C_TRACE_DROP`` counts)."""
        if self._trace_n is None:
            raise RuntimeError("TraceStream not finalized — run the engine "
                               "with the stream attached first")
        n = int(self._trace_n[agent])
        segs = self._segments.get(agent, {})
        out, pos = [], 0
        for start in sorted(segs):
            seg = segs[start]
            if start != pos:
                raise RuntimeError(
                    f"trace stream gap for agent {agent}: have rows "
                    f"[0, {pos}), next span starts at {start}")
            out.append(seg)
            pos += seg.shape[0]
        if pos != n:
            raise RuntimeError(
                f"trace stream incomplete for agent {agent}: streamed {pos} "
                f"of {n} rows")
        if not out:
            return np.zeros((0, 4), np.int32)
        return np.concatenate(out, axis=0)

    def merged(self) -> list:
        """The global (time, seq)-ordered trace as ``(time, seq, kind,
        dst)`` int tuples: ``merged_engine_trace``'s list."""
        rows = []
        assert self._trace_n is not None
        for a in range(self._trace_n.shape[0]):
            rows.extend(tuple(int(x) for x in r) for r in self.agent_rows(a))
        rows.sort(key=lambda r: (r[0], r[1]))
        return rows


class MetricsStream:
    """Periodic fleet snapshots of the registry's counters.

    The engine hands every agent's ``(window, gvt, counters)`` to
    :meth:`on_window` at the end of each window whose index is a multiple
    of ``interval``; once all agents of the window have reported, one JSON
    line lands on ``out`` (and in ``self.lines``):

        {"window": W, "gvt": T, "agents": A, "counters": {name: total}}

    Names and their order come from the registry (extension counters
    included). A final snapshot (``"final": true``) closes every run.
    """

    def __init__(self, interval: int = 32, out=None):
        if interval <= 0:
            raise ValueError(f"interval must be positive, got {interval}")
        self.interval = int(interval)
        self.out = out
        self.lines: list[dict] = []
        self.latest: dict | None = None
        self._booked: dict[str, int] = {}
        self._resume: list[dict] | None = None

    def begin(self, n_agents: int, registry=None) -> None:
        """Reset for a run (the engine calls this with its registry).
        Records staged by :meth:`load_state` seed ``self.lines`` without
        being written to ``out`` again, so a resumed run's records continue
        the uninterrupted run's. Booked fleet counters survive the reset."""
        self.n_agents = n_agents
        self._names = (registry.counters if registry is not None else {
            name: i for i, (name, _doc) in enumerate(BUILTIN_COUNTERS)})
        self._pending: dict[int, dict[int, tuple]] = {}
        self.lines = list(self._resume) if self._resume is not None else []
        self._resume = None
        self.latest = self.lines[-1] if self.lines else None

    # --------------------------------------------------- checkpoint support
    def state_dict(self) -> dict[str, np.ndarray]:
        """The emitted records as one uint8 array of their JSON (what
        ``SimCheckpointer`` saves)."""
        payload = json.dumps(self.lines).encode("utf-8")
        return {"lines": np.frombuffer(payload, dtype=np.uint8).copy()}

    def load_state(self, arrays: dict[str, np.ndarray]) -> None:
        """Stage checkpointed records for the next ``begin()``."""
        payload = bytes(np.asarray(arrays["lines"]).tobytes())
        self._resume = json.loads(payload.decode("utf-8"))

    # ------------------------------------------------ fleet-counter overlay
    def book(self, name: str, amount: int = 1) -> None:
        """Add a host-side counter to the named column of every later
        record (a fleet orchestrator's preemption bookkeeping, which must
        not enter the engine's counters)."""
        self._booked[name] = self._booked.get(name, 0) + int(amount)

    def on_window(self, agent, window, gvt, counters) -> None:
        """One agent's end-of-window counter vector (arrays over agents are
        unrolled lane by lane)."""
        agent = np.asarray(agent)
        if agent.ndim:
            for i in range(agent.shape[0]):
                self.on_window(agent[i], np.asarray(window)[i],
                               np.asarray(gvt)[i], np.asarray(counters)[i])
            return
        a, w = int(agent), int(window)
        if a >= self.n_agents or w % self.interval:
            return
        got = self._pending.setdefault(w, {})
        got[a] = (int(gvt), np.asarray(counters).copy())
        if len(got) == self.n_agents:
            self._emit(w, self._pending.pop(w))

    def _emit(self, window: int, got: dict, final: bool = False) -> None:
        total = np.sum([c for _gvt, c in got.values()], axis=0)
        rec = {
            "window": window,
            "gvt": max(g for g, _c in got.values()),
            "agents": self.n_agents,
            "counters": {name: int(total[i])
                         for name, i in self._names.items()},
        }
        for name, v in self._booked.items():
            if name in rec["counters"]:
                rec["counters"][name] += v
        if final:
            rec["final"] = True
        self.latest = rec
        self.lines.append(rec)
        if self.out is not None:
            self.out.write(json.dumps(rec) + "\n")
            self.out.flush()

    def finalize(self, counters, windows, t_now) -> None:
        """Emit the end-of-run snapshot from the finished state (numpy)."""
        counters = np.asarray(counters)
        windows = np.asarray(windows)
        t_now = np.asarray(t_now)
        got = {a: (int(t_now[a]), counters[a])
               for a in range(min(self.n_agents, counters.shape[0]))}
        self._emit(int(windows[0]), got, final=True)

    # ------------------------------------------------------ ensemble support
    def ensemble(self, seeds, counters, windows, t_now) -> dict:
        """Reduce an ``Engine.run_ensemble`` result into the stream.

        ``counters`` is the (R, A, N) counter table of R replicas; each
        replica's agents sum to its fleet totals, kept as
        ``self.replica_counters`` (R, N) beside ``self.replica_seeds`` (one
        replica's books come back through :meth:`replica`). One summary
        record (min, mean and max over replicas per counter, and the
        ensemble's totals) lands on ``out`` and in ``self.lines``."""
        seeds = np.asarray(seeds)
        counters = np.asarray(counters)
        windows = np.asarray(windows)
        t_now = np.asarray(t_now)
        self.replica_seeds = seeds.copy()
        self.replica_counters = counters.sum(axis=1)
        total = self.replica_counters.sum(axis=0)
        rec = {
            "ensemble": int(seeds.shape[0]),
            "agents": self.n_agents,
            "windows": [int(windows.min()), int(windows.max())],
            "gvt": [int(t_now.min()), int(t_now.max())],
            "counters": {name: int(total[i])
                         for name, i in self._names.items()},
            "per_replica": {
                name: {"min": int(self.replica_counters[:, i].min()),
                       "mean": float(self.replica_counters[:, i].mean()),
                       "max": int(self.replica_counters[:, i].max())}
                for name, i in self._names.items()},
        }
        self.latest = rec
        self.lines.append(rec)
        if self.out is not None:
            self.out.write(json.dumps(rec) + "\n")
            self.out.flush()
        return rec

    def replica(self, r: int) -> dict:
        """One replica's fleet-total counters by name (after
        :meth:`ensemble`)."""
        return {name: int(self.replica_counters[r, i])
                for name, i in self._names.items()}
