"""Workload bridge: a multi-pod training job simulated with the DES
(counterpart of ``repro.core.workload``).

An (arch x shape x mesh) cell's roofline terms parameterize a scenario whose
pods are compute farms and whose cross-pod gradient traffic shares one WAN
region under the interrupt-based traffic model. Per pod p:

  farm_p: one CPU unit, power 1.0, so a per-step compute job lasts
          ``t_compute`` ticks (the first pod ``slow_pod_factor`` times as
          long: a straggler);
  gen_p:  the pod's gradient FLOW_START on WAN link p each step, whose
          completion submits the next step's job.

Every pod starts its gradient flow on the same region at the same tick, so
each step is a storm of flow interrupts: max-min fairness over ``2 *
n_pods`` flow slots and ``n_pods`` links sets the simulated step time.
``simulate_training`` returns it beside the analytic roofline estimate.

The region's link table holds ``max(4, n_pods)`` links. The reference's holds
4 and asserts that the pods fit, so it runs at most 4 pods; up to 4 pods the
two scenarios are the same.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import monitoring as mon
from repro_torch.core.components import (FLOW_START, JOB_SUBMIT,
                                         K_FLOW_START, K_JOB_SUBMIT,
                                         ScenarioBuilder)
from repro_torch.core.engine import Engine

TICK = 1e-6            # 1 tick = 1 us simulated


@dataclasses.dataclass(frozen=True)
class CellModel:
    """Distilled cell description (from roofline terms)."""
    n_pods: int
    t_compute_s: float        # per-step per-chip compute+memory time
    dcn_bytes_per_pod: float  # cross-pod gradient traffic per step
    dcn_gbps: float = 25.0    # per-pod DCN bandwidth (GB/s)
    n_steps: int = 8
    slow_pod_factor: float = 1.0   # >1: one pod is a straggler


def training_scenario(cell: CellModel, n_agents: int = 1):
    """The built scenario of a cell: ``(world, own, init_events, spec)``."""
    b = ScenarioBuilder(max_cpu=4, queue_cap=16,
                        max_link=max(4, cell.n_pods),
                        max_flow=max(16, 2 * cell.n_pods))
    t_comp_ticks = max(int(cell.t_compute_s / TICK), 10)
    mb_per_tick = cell.dcn_gbps * 1e3 * TICK
    grad_mb = max(cell.dcn_bytes_per_pod / 1e6, 1e-3)

    farms = [b.add_farm([1.0]) for _ in range(cell.n_pods)]
    wan = b.add_net_region(link_bws=[mb_per_tick] * cell.n_pods,
                           link_lats=[50] * cell.n_pods)
    # per pod: the step-0 compute job, whose completion notifies the WAN
    # region
    for p, f in enumerate(farms):
        work = t_comp_ticks * (cell.slow_pod_factor if p == 0 else 1.0)
        b.add_event(time=1, kind=K_JOB_SUBMIT, src=f, dst=f,
                    payload=JOB_SUBMIT.pack(work=work, mem=1.0, notify_lp=wan,
                                            notify_kind=K_FLOW_START,
                                            size=grad_mb))
    # JOB_END forwards only the size, so per-pod generators drive the
    # repeating steps
    horizon = int(cell.n_steps * (t_comp_ticks * cell.slow_pod_factor
                                  + grad_mb / mb_per_tick + 200) * 2)
    for p, f in enumerate(farms):
        work = t_comp_ticks * (cell.slow_pod_factor if p == 0 else 1.0)
        step_ticks = int(work + grad_mb / mb_per_tick + 120)
        b.add_generator(target_lp=wan, kind=K_FLOW_START,
                        payload=FLOW_START.pack(size=grad_mb, l0=p,
                                                notify_lp=f,
                                                notify_kind=K_JOB_SUBMIT),
                        interval=step_ticks, count=cell.n_steps,
                        start=int(work))
    return b.build(n_agents=n_agents, lookahead=10, t_end=max(horizon, 1000),
                   pool_cap=1024, work_per_mb=t_comp_ticks / grad_mb)


def simulate_training(cell: CellModel, *, n_agents: int = 1,
                      max_windows: int = 200_000, device=None) -> dict:
    """Chained step simulation; returns the simulated step time and
    counters. Runs on the CUDA card unless ``device`` says otherwise."""
    eng = Engine(*training_scenario(cell, n_agents), device=device)
    return summarize(cell, eng.run_local(max_windows=max_windows))


def summarize(cell: CellModel, st) -> dict:
    """``simulate_training``'s dict from a finished run's ``EngineState``."""
    c = st.counters.sum(0).tolist()
    t_end_sim = int(st.world.lp_lvt[0].max())
    steps_done = c[mon.C_FLOWS_DONE] / max(cell.n_pods, 1)
    sim_step_s = (t_end_sim * TICK / max(steps_done, 1e-9))
    analytic_s = cell.t_compute_s + cell.dcn_bytes_per_pod / (
        cell.dcn_gbps * 1e9)
    return {
        "simulated_step_s": sim_step_s,
        "analytic_step_s": analytic_s,
        "steps_done": steps_done,
        "events": c[mon.C_EVENTS],
        "interrupts": c[mon.C_INTERRUPTS],
        "stale": c[mon.C_STALE],
        "windows": int(st.windows[0]),
    }


def cell_from_roofline(row: dict, *, n_pods: int = 2, n_steps: int = 8,
                       slow_pod_factor: float = 1.0) -> CellModel:
    """A CellModel from a dry-run roofline row (results/dryrun/*.json)."""
    t_cm = max(row["t_compute_s"], row["t_memory_s"])
    # cross-pod traffic ~ the all-reduce share of collective bytes
    dcn = row.get("coll_by_kind", {}).get("all-reduce", 0.0)
    return CellModel(n_pods=n_pods, t_compute_s=t_cm,
                     dcn_bytes_per_pod=dcn, n_steps=n_steps,
                     slow_pod_factor=slow_pod_factor)
