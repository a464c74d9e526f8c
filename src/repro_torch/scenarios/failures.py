"""Failure/repair process LP, a component defined outside core (counterpart
of ``repro.scenarios.failures``).

The paper's availability studies model resources that fail and recover
while the workload runs. A *failure process* LP tortures a compute farm with
bursts of CPU failures at pseudo-exponential intervals, and repair events
bring the CPUs back. It is the stress case the adaptive exec policy was
built for: a burst makes a window dense, the gaps leave others nearly empty.

* ``FAIL_TICK`` (table ``fproc``) fires a burst of up to ``MAX_EMIT - 1``
  same-tick ``CPU_FAIL`` events at the target farm and schedules the next
  tick; a wider burst is truncated and counted in ``FAIL_BURST_TRUNC``.
* ``CPU_FAIL`` and ``CPU_REPAIR`` declare the builtin ``farm`` table, so a
  burst on one farm serialises through the conflict fallback while distinct
  farms batch. A repair pops the farm's FIFO head onto the repaired CPU.
* The failed slot and the repair delay travel as int32 payload fields, as
  raw bits in the float32 payload lanes.

Randomness is an in-handler LCG carried in mutable component state, so the
oracle replays the same stream. The exponential draw takes the logarithm
of XLA:CPU, bit for bit (:func:`xla_log`), so the delays equal the
reference's on every device.
"""
from __future__ import annotations

import struct

import torch

from repro_torch.core import events as ev
from repro_torch.core import handlers as hd
from repro_torch.core import monitoring as mon
from repro_torch.core import tensor_util as tu
from repro_torch.core.components import BUILTIN, JOB_SUBMIT, ScenarioBuilder
from repro_torch.core.registry import (FieldSpec, PayloadSpec, Registry,
                                       ScenarioBuilderBase)

f32, f64, i32 = torch.float32, torch.float64, torch.int32


def _hex(h: str) -> float:
    return struct.unpack(">d", bytes.fromhex(h))[0]


# Cephes' logf constants as XLA:CPU's compiled log holds them (hex doubles,
# each a float32 value): the polynomial P0..P8, then ln 2 split in two.
_P = tuple(_hex(h) for h in (
    "3FB2043760000000", "BFBD7A3700000000", "3FBDE4A340000000",
    "BFBFCBA9E0000000", "3FC23D37E0000000", "BFC555CA00000000",
    "3FC999D580000000", "BFCFFFFF80000000", "3FD5555540000000"))
_Q1, _Q2 = _hex("BF2BD01060000000"), _hex("3FE6300000000000")
_SQRTHF = _hex("3FE6A09E60000000")
_FLT_MIN = 1.1754943508222875e-38


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add (the
    product of two float32 values is exact in float64)."""
    c = c.to(f64) if isinstance(c, torch.Tensor) else c
    return (a.to(f64) * b + c).to(f32)


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """float32 natural logarithm of positive finite ``x``, bit-equal to
    XLA:CPU's ``jnp.log``: Eigen's ``plog`` (Cephes' polynomial in three
    interleaved chains) with every multiply-add fused, as the compiled
    kernel evaluates it. Float32 ops, the fused steps in float64."""
    x = torch.clamp_min(x.to(f32), _FLT_MIN)
    b = x.view(i32)
    e = ((b >> 23) - 127).to(f32) + 1.0
    m = ((b & 0x007FFFFF) | 0x3F000000).view(f32)          # [0.5, 1)
    s = m < _SQRTHF
    t = (m - 1.0) + torch.where(s, m, torch.zeros_like(m))
    e = e - s.to(f32)
    t2 = t * t
    t3 = t2 * t
    y = _fma(t, _P[0], _P[1])
    y1 = _fma(t, _P[3], _P[4])
    y2 = _fma(t, _P[6], _P[7])
    y = _fma(y, t.to(f64), _P[2])
    y1 = _fma(y1, t.to(f64), _P[5])
    y2 = _fma(y2, t.to(f64), _P[8])
    y = _fma(y, t3.to(f64), y1)
    y = _fma(y, t3.to(f64), y2)
    inner = (t - 0.5 * t2) + _fma(y, t3.to(f64), _Q1 * e)
    return _fma(e, _Q2, inner)


def _lcg(rng: torch.Tensor) -> torch.Tensor:
    """One step of the 32-bit LCG, wrapping in int32 as the reference."""
    x = (rng.to(torch.int64) * 1664525 + 1013904223) & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x).to(i32)


def _unit(rng: torch.Tensor) -> torch.Tensor:
    """(0, 1) float32 from the LCG's high bits (arithmetic shift + mask)."""
    bits = (rng >> 9) & ((1 << 22) - 1)
    return (bits.to(f32) + 0.5) / float(1 << 22)


def _expo(rng: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """Pseudo-exponential delay with the given mean, in [1, 8 * mean]
    ticks."""
    m = torch.clamp_min(mean, 1).to(f32)
    d = torch.ceil(-m * xla_log(_unit(rng)))
    return tu.f2i(torch.minimum(torch.clamp_min(d, 1.0), 8.0 * m))


def register_failure_model(reg: Registry) -> dict:
    """Declare the failure-process component, kinds, handlers and counters."""
    c_fails = reg.counter("CPU_FAILS", "CPU slots taken down by failures")
    c_repairs = reg.counter("CPU_REPAIRS", "CPU slots brought back up")
    c_bursts = reg.counter("FAIL_BURSTS", "failure bursts fired")
    c_trunc = reg.counter(
        "FAIL_BURST_TRUNC",
        f"failures not emitted because fp_burst exceeded the "
        f"{ev.MAX_EMIT - 1} emit slots a FAIL_TICK carries")

    fproc = reg.component("fproc", doc="failure/repair process LP", fields=dict(
        fp_target=FieldSpec((), i32, doc="farm LP the process torments"),
        fp_burst=FieldSpec((), i32, fill=1,
                           doc=f"CPU failures per burst (<= {ev.MAX_EMIT - 1})"),
        fp_fail_mean=FieldSpec((), i32, fill=16,
                               doc="mean ticks between bursts (exponential)"),
        fp_repair_mean=FieldSpec((), i32, fill=8,
                                 doc="mean ticks a failed CPU stays down"),
        fp_rng=FieldSpec((), i32, mutable=True, doc="LCG state"),
        fp_left=FieldSpec((), i32, mutable=True,
                          doc="remaining bursts to fire"),
    ))
    fail_payload = PayloadSpec(("slot", 0, i32), ("repair_delay", 1, i32))
    tick = reg.kind("FAIL_TICK", table="fproc")
    fail = reg.kind("CPU_FAIL", table="farm", payload=fail_payload)
    repair = reg.kind("CPU_REPAIR", table="farm",
                      payload=PayloadSpec(("slot", 0, i32)))

    def row(world, name, e, r):
        return tu.take(getattr(world, name), e.agent, r)

    @reg.on(tick)
    def h_fail_tick(env, world, counters, e):
        g = row(world, "lp_res", e, e.dst)
        rng = row(world, "fp_rng", e, g)
        left = row(world, "fp_left", e, g)
        burst = row(world, "fp_burst", e, g)
        fire = left > 0
        n_cpu = world.cpu_busy.shape[2]
        out = hd.Emits(e)
        # the burst: up to MAX_EMIT - 1 same-tick CPU_FAILs at the target
        for s in range(ev.MAX_EMIT - 1):
            rng = _lcg(rng)
            slot = ((rng >> 7) & (2**24 - 1)) % n_cpu
            rng = _lcg(rng)
            delay = _expo(rng, row(world, "fp_repair_mean", e, g))
            out.set(s, valid=fire & (s < burst), time=e.time + env.delay(1),
                    kind=fail.id, dst=row(world, "fp_target", e, g),
                    payload=fail_payload.pack_tensor(slot=slot,
                                                     repair_delay=delay))
        # the next burst after a pseudo-exponential gap
        rng = _lcg(rng)
        gap = _expo(rng, row(world, "fp_fail_mean", e, g))
        out.set(ev.MAX_EMIT - 1, valid=fire & (left > 1),
                time=e.time + env.delay(gap), kind=tick.id, dst=e.dst,
                payload=0.0)
        counters = mon.bump(counters, c_bursts, fire.to(i32))
        # a burst wider than the emit slots is truncated, and counted
        trunc = torch.clamp_min(burst - (ev.MAX_EMIT - 1), 0)
        counters = mon.bump(counters, c_trunc, torch.where(fire, trunc, 0))
        delta = env.delta(world, "fproc", g, fp_rng=rng,
                          fp_left=left - fire.to(i32))
        return delta, counters, out.batch()

    @reg.on(fail)
    def h_cpu_fail(env, world, counters, e):
        f = row(world, "lp_res", e, e.dst)
        slot = fail_payload.get(e.payload, "slot")
        busy = hd.set_slot(row(world, "cpu_busy", e, f), slot, 1)
        memr = hd.set_slot(row(world, "cpu_mem", e, f), slot, 0.0)
        counters = mon.bump(counters, c_fails)
        out = hd.Emits(e)
        out.set(0, valid=True,
                time=e.time + env.delay(fail_payload.get(e.payload,
                                                         "repair_delay")),
                kind=repair.id, dst=e.dst,
                payload=repair.payload.pack_tensor(slot=slot))
        delta = env.delta(world, "farm", f, cpu_busy=busy, cpu_mem=memr,
                          jobq=row(world, "jobq", e, f),
                          jobq_n=row(world, "jobq_n", e, f))
        return delta, counters, out.batch()

    @reg.on(repair)
    def h_cpu_repair(env, world, counters, e):
        """Bring the slot back up and, like JOB_END, pop the FIFO head onto
        the repaired CPU (``handlers.start_queued_job``)."""
        f = row(world, "lp_res", e, e.dst)
        slot = repair.payload.get(e.payload, "slot")
        counters = mon.bump(counters, c_repairs)
        out = hd.Emits(e)
        busy_v, mem_v, new_jq, new_qn = hd.start_queued_job(
            env, world, f, slot, e, out, 0)
        delta = env.delta(
            world, "farm", f,
            cpu_busy=hd.set_slot(row(world, "cpu_busy", e, f), slot, busy_v),
            cpu_mem=hd.set_slot(row(world, "cpu_mem", e, f), slot, mem_v),
            jobq=new_jq, jobq_n=new_qn)
        return delta, counters, out.batch()

    return dict(fproc=fproc, FAIL_TICK=tick, CPU_FAIL=fail, CPU_REPAIR=repair,
                C_CPU_FAILS=c_fails, C_CPU_REPAIRS=c_repairs,
                C_FAIL_BURSTS=c_bursts, C_FAIL_BURST_TRUNC=c_trunc)


FAIL_REGISTRY = BUILTIN.extend()
_DEFS = register_failure_model(FAIL_REGISTRY)
FPROC = _DEFS["fproc"]
FAIL_TICK = _DEFS["FAIL_TICK"]
CPU_FAIL = _DEFS["CPU_FAIL"]
CPU_REPAIR = _DEFS["CPU_REPAIR"]
C_CPU_FAILS = _DEFS["C_CPU_FAILS"]
C_CPU_REPAIRS = _DEFS["C_CPU_REPAIRS"]
C_FAIL_BURSTS = _DEFS["C_FAIL_BURSTS"]
C_FAIL_BURST_TRUNC = _DEFS["C_FAIL_BURST_TRUNC"]
K_FAIL_TICK = FAIL_TICK.id
LPK_FPROC = FPROC.lp_kind


class FailureScenarioBuilder(ScenarioBuilder):
    """The builtin builder plus the generated ``add_fproc(...)``."""

    _registry = FAIL_REGISTRY

    def __init__(self, max_cpu: int = 16, queue_cap: int = 32,
                 max_link: int = 8, max_flow: int = 64):
        ScenarioBuilderBase.__init__(
            self, max_cpu=max_cpu, queue_cap=queue_cap, max_link=max_link,
            max_flow=max_flow)


def build_failure_scenario(*, n_farms: int = 8, n_cpu: int = 4,
                           procs_per_farm: int = 1, burst: int = 3,
                           fail_mean: int = 12, repair_mean: int = 6,
                           n_bursts: int = 6, jobs_per_farm: int = 0,
                           job_interval: int = 8, seed: int = 1,
                           lookahead: int = 2, n_agents: int = 1,
                           pool_cap: int = 1024, **build_kw):
    """Farms under failure/repair churn, optionally with a job workload.

    One failure process per (farm, proc) pair; distinct farms batch,
    ``procs_per_farm > 1`` (or ``burst > 1``) forces same-row collisions
    through the sequential fallback. ``jobs_per_farm`` adds a JOB_SUBMIT
    generator per farm, so failures contend with jobs for CPU slots.
    """
    if burst > ev.MAX_EMIT - 1:
        raise ValueError(
            f"burst={burst} exceeds the {ev.MAX_EMIT - 1} CPU_FAIL emit "
            "slots a FAIL_TICK carries (excess would be truncated and "
            "counted in FAIL_BURST_TRUNC)")
    b = FailureScenarioBuilder(max_cpu=n_cpu, queue_cap=8, max_link=1,
                               max_flow=2)
    farms = [b.add_farm([1.0] * n_cpu) for _ in range(n_farms)]
    procs = []
    for i, farm in enumerate(farms):
        for p in range(procs_per_farm):
            lp = b.add_fproc(fp_target=farm, fp_burst=burst,
                             fp_fail_mean=fail_mean,
                             fp_repair_mean=repair_mean,
                             fp_rng=seed + 7919 * (i * procs_per_farm + p),
                             fp_left=n_bursts)
            b.add_event(time=1 + (i * procs_per_farm + p) % lookahead,
                        kind=FAIL_TICK, src=lp, dst=lp)
            procs.append(lp)
    for farm in farms[: n_farms if jobs_per_farm else 0]:
        b.add_generator(target_lp=farm, kind=JOB_SUBMIT,
                        payload=JOB_SUBMIT.pack(work=3.0, mem=1.0),
                        interval=job_interval, count=jobs_per_farm)
    t_end = (n_bursts + 2) * 8 * max(fail_mean, repair_mean)
    built = b.build(n_agents=n_agents, lookahead=lookahead, t_end=t_end,
                    pool_cap=pool_cap, **build_kw)
    return built, dict(farms=farms, procs=procs)
