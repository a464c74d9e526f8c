"""Simulation components (paper §4.2), declared through the registry
(counterpart of ``repro.core.components``).

Every component class is a structure-of-arrays table inside ``World``;
``lp_res`` maps a logical process to its row. The four built-in components,
the eight event kinds and every table derived from them are generated by
:mod:`repro_torch.core.registry` from :func:`register_builtin_model`.
"""
from __future__ import annotations

import torch

from repro_torch.core.registry import (  # noqa: F401  (re-exported)
    LPS_CREATED, LPS_FINISHED, LPS_READY, LPS_RUNNING, LPS_WAITING, PAYLOAD,
    FieldSpec, PayloadSpec, Registry, ScenarioBuilderBase, ScenarioSpec,
    registry_of)

MAXHOP = 3  # max links on a flow route

f32, i32 = torch.float32, torch.int32


def register_builtin_model(reg: Registry) -> dict:
    """Declare the paper's four basic components and eight event kinds."""
    reg.dim("max_cpu", 16)
    reg.dim("queue_cap", 32)
    reg.dim("max_link", 8)
    reg.dim("max_flow", 64)

    farm = reg.component("farm", doc="compute farm: CPU units + FIFO job queue", fields=dict(
        cpu_power=FieldSpec(("max_cpu",), f32, doc="ops/tick; 0 => slot absent"),
        cpu_busy=FieldSpec(("max_cpu",), i32, mutable=True, doc="1 while a job runs"),
        cpu_mem=FieldSpec(("max_cpu",), f32, mutable=True, doc="memory used by the running job"),
        jobq=FieldSpec(("queue_cap", 6), f32, mutable=True, doc="queued [work, mem, nlp, nkind, size, _]"),
        jobq_n=FieldSpec((), i32, mutable=True, doc="queue occupancy"),
    ))
    net = reg.component("net", doc="network region: links + flows", fields=dict(
        link_bw=FieldSpec(("max_link",), f32, doc="MB/tick; 0 => absent"),
        link_lat=FieldSpec(("max_link",), i32, doc="ticks"),
        flow_active=FieldSpec(("max_flow",), torch.bool, mutable=True),
        flow_rem=FieldSpec(("max_flow",), f32, mutable=True, doc="MB remaining"),
        flow_rate=FieldSpec(("max_flow",), f32, mutable=True, doc="MB/tick (current fair share)"),
        flow_tlast=FieldSpec(("max_flow",), i32, mutable=True, doc="last progress timestamp"),
        flow_links=FieldSpec(("max_flow", MAXHOP), i32, mutable=True, fill=-1, doc="route; -1 pads"),
        flow_notify=FieldSpec(("max_flow", 6), f32, mutable=True, doc="[nlp, nkind, work, size, n2lp, n2kind]"),
        net_gen=FieldSpec((), i32, mutable=True, doc="interrupt generation counter"),
    ))
    sto = reg.component("sto", doc="storage: db server disk + mass-storage tape", fields=dict(
        sto_cap=FieldSpec((2,), f32, doc="[disk, tape] capacity MB"),
        sto_used=FieldSpec((2,), f32, mutable=True, doc="[disk, tape] used MB"),
        sto_rate=FieldSpec((), f32, doc="tape migration MB/tick"),
        sto_flag=FieldSpec((), i32, mutable=True, doc="1 while a disk->tape migration is scheduled"),
    ))
    gen = reg.component("gen", doc="activity generator", fields=dict(
        gen_interval=FieldSpec((), i32, fill=1, doc="ticks between emissions"),
        gen_left=FieldSpec((), i32, mutable=True, doc="remaining emissions"),
        gen_target=FieldSpec((), i32, doc="destination LP for generated events"),
        gen_kind=FieldSpec((), i32, doc="kind of generated event"),
        gen_payload=FieldSpec((PAYLOAD,), f32, doc="template payload"),
    ))

    kinds = dict(
        NOOP=reg.kind("NOOP"),
        FLOW_START=reg.kind("FLOW_START", table="net", payload=PayloadSpec(
            "size", ("l0", -1), ("l1", -1), ("l2", -1),
            ("notify_lp", -1), "notify_kind", ("notify2_lp", -1),
            "notify2_kind")),
        FLOW_END=reg.kind("FLOW_END", table="net", payload=PayloadSpec("gen")),
        JOB_SUBMIT=reg.kind("JOB_SUBMIT", table="farm", payload=PayloadSpec(
            "work", "mem", ("notify_lp", -1), "notify_kind", "size")),
        JOB_END=reg.kind("JOB_END", table="farm", payload=PayloadSpec(
            "slot", "work", "mem", ("notify_lp", -1), "notify_kind", "size")),
        DATA_WRITE=reg.kind("DATA_WRITE", table="sto",
                            payload=PayloadSpec("size")),
        MIGRATE=reg.kind("MIGRATE", table="sto", payload=PayloadSpec("amount")),
        GEN_TICK=reg.kind("GEN_TICK", table="gen"),
    )
    return dict(farm=farm, net=net, sto=sto, gen=gen, **kinds)


BUILTIN = Registry()
BUILTIN.deferred_handler_modules.append("repro_torch.core.handlers")
_DEFS = register_builtin_model(BUILTIN)

FARM, NET, STO, GEN = _DEFS["farm"], _DEFS["net"], _DEFS["sto"], _DEFS["gen"]
NOOP, FLOW_START, FLOW_END = (_DEFS["NOOP"], _DEFS["FLOW_START"],
                              _DEFS["FLOW_END"])
JOB_SUBMIT, JOB_END = _DEFS["JOB_SUBMIT"], _DEFS["JOB_END"]
DATA_WRITE, MIGRATE, GEN_TICK = (_DEFS["DATA_WRITE"], _DEFS["MIGRATE"],
                                 _DEFS["GEN_TICK"])

LPK_IDLE = 0
LPK_FARM = FARM.lp_kind
LPK_NET = NET.lp_kind
LPK_STORAGE = STO.lp_kind
LPK_GEN = GEN.lp_kind

K_NOOP = NOOP.id
K_FLOW_START = FLOW_START.id
K_FLOW_END = FLOW_END.id
K_JOB_SUBMIT = JOB_SUBMIT.id
K_JOB_END = JOB_END.id
K_DATA_WRITE = DATA_WRITE.id
K_MIGRATE = MIGRATE.id
K_GEN_TICK = GEN_TICK.id
N_KINDS = BUILTIN.n_kinds
KIND_TABLE = BUILTIN.kind_table
TBL_NONE = 0
TBL_FARM = FARM.table_id
TBL_NET = NET.table_id
TBL_STORAGE = STO.table_id
TBL_GEN = GEN.table_id
N_TABLES = BUILTIN.n_tables

World = BUILTIN.world_struct()
WorldOwnership = BUILTIN.ownership_struct()


def sync_world(world, own):
    """Owner-wins replication sync over the agent dimension (identity for a
    single agent); see ``Registry.sync_world``."""
    return registry_of(world).sync_world(world, own)


class ScenarioBuilder(ScenarioBuilderBase):
    """Imperative builder in the paper's "regional center" style."""

    _registry = BUILTIN

    def __init__(self, max_cpu: int = 16, queue_cap: int = 32,
                 max_link: int = 8, max_flow: int = 64):
        super().__init__(max_cpu=max_cpu, queue_cap=queue_cap,
                         max_link=max_link, max_flow=max_flow)

    def add_farm(self, cpu_powers, ctx: int = 0) -> int:
        if len(cpu_powers) > self.max_cpu:
            raise ValueError(f"{len(cpu_powers)} CPUs exceed max_cpu="
                             f"{self.max_cpu}")
        return self.add_component("farm", cpu_power=list(cpu_powers), ctx=ctx)

    def add_net_region(self, link_bws, link_lats, ctx: int = 0) -> int:
        if len(link_bws) > self.max_link:
            raise ValueError(f"{len(link_bws)} links exceed max_link="
                             f"{self.max_link}")
        return self.add_component("net", link_bw=list(link_bws),
                                  link_lat=list(link_lats), ctx=ctx)

    def add_storage(self, disk_cap: float, tape_cap: float, tape_rate: float,
                    ctx: int = 0) -> int:
        return self.add_component("sto", sto_cap=[disk_cap, tape_cap],
                                  sto_rate=tape_rate, ctx=ctx)

    def add_generator(self, target_lp: int, kind, payload, interval: int,
                      count: int, start: int = 0, ctx: int = 0) -> int:
        lp = self.add_component(
            "gen", gen_interval=interval, gen_left=count,
            gen_target=target_lp, gen_kind=getattr(kind, "id", kind),
            gen_payload=list(payload), ctx=ctx)
        self.add_event(time=start, kind=K_GEN_TICK, src=lp, dst=lp, ctx=ctx)
        return lp

    def add_regional_center(self, n_cpu: int, cpu_power: float, disk: float,
                            tape: float, tape_rate: float, ctx: int = 0):
        farm = self.add_farm([cpu_power] * n_cpu, ctx=ctx)
        sto = self.add_storage(disk, tape, tape_rate, ctx=ctx)
        return dict(farm=farm, storage=sto)
