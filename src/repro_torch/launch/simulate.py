"""Simulation launcher of the port (the ``t0t1`` mode of
``repro.launch.simulate``).

  t0t1   reproduce the paper's §3.1 CERN study: a T0 -> T1 WAN bandwidth
         sweep, printing events, stale completions, interrupts, MB moved and
         windows per bandwidth.

Runs on the CUDA card unless ``--device cpu`` is given:

    PYTHONPATH=src python -m repro_torch.launch.simulate t0t1 --device cuda
"""
from __future__ import annotations

import argparse

from repro_torch.core import monitoring as mon


def t0t1_scenario(bw: float, flows: int, agents: int, exec_cap=None,
                  batched_dispatch: bool = True, **spec_kw):
    """The T0/T1 replication study at WAN bandwidth ``bw`` (MB/tick)."""
    from repro_torch.core import ScenarioBuilder
    from repro_torch.core.components import DATA_WRITE, FLOW_START, JOB_SUBMIT

    b = ScenarioBuilder(max_cpu=4, queue_cap=16, max_link=4, max_flow=32)
    b.add_regional_center(n_cpu=2, cpu_power=10.0, disk=2000.0,
                          tape=20000.0, tape_rate=5.0)
    t1 = b.add_regional_center(n_cpu=2, cpu_power=8.0, disk=2000.0,
                               tape=20000.0, tape_rate=5.0)
    wan = b.add_net_region(link_bws=[bw, bw], link_lats=[5, 5])
    b.add_generator(target_lp=wan, kind=FLOW_START,
                    payload=FLOW_START.pack(
                        size=40.0, l0=0, notify_lp=t1["farm"],
                        notify_kind=JOB_SUBMIT.id,
                        notify2_lp=t1["storage"],
                        notify2_kind=DATA_WRITE.id),
                    interval=15, count=flows)
    return b.build(n_agents=agents, lookahead=2, t_end=100_000,
                   pool_cap=1024, work_per_mb=2.0, exec_cap=exec_cap,
                   batched_dispatch=batched_dispatch, **spec_kw)


def run_t0t1(args) -> list[str]:
    from repro_torch.core import Engine

    lines = []
    for bw in args.bandwidths:
        world, own, init_ev, spec = t0t1_scenario(
            bw, args.flows, args.agents, args.exec_cap,
            args.batched_dispatch, merge_mode=args.merge_mode,
            insert_mode=args.insert_mode, fused_select=args.fused_select)
        st = Engine(world, own, init_ev, spec,
                    device=args.device).run_local(max_windows=200_000)
        c = st.counters.sum(0).cpu()
        line = (f"[t0t1] bw={bw:7.3f} MB/tick  "
                f"events={int(c[mon.C_EVENTS]):6d} "
                f"stale={int(c[mon.C_STALE]):5d} "
                f"interrupts={int(c[mon.C_INTERRUPTS]):5d} "
                f"MB={int(c[mon.C_MB_TRANSFERRED])} "
                f"windows={int(st.windows[0])}")
        print(line, flush=True)
        lines.append(line)
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="mode", required=True)
    p1 = sub.add_parser("t0t1")
    p1.add_argument("--bandwidths", type=float, nargs="+",
                    default=[8.0, 2.0, 0.5, 0.125])
    p1.add_argument("--flows", type=int, default=24)
    p1.add_argument("--agents", type=int, default=1)
    p1.add_argument("--exec-cap", type=int, default=None,
                    help="per-window compacted execution cap "
                         "(default min(pool_cap, 256))")
    p1.add_argument("--batched-dispatch", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="grouped batched handler dispatch (engine step 4); "
                         "--no-batched-dispatch runs the sequential fold")
    p1.add_argument("--merge-mode", choices=("delta", "dense"),
                    default="delta",
                    help="batched merge: per-row delta scatters (default) "
                         "or the whole-table reference merge")
    p1.add_argument("--insert-mode", choices=("ring", "ref"), default="ring",
                    help="event-pool lifecycle: free-list ring (default) or "
                         "the O(pool_cap) reference rank scan")
    p1.add_argument("--fused-select", action="store_true",
                    help="run the window front end (select, gather, "
                         "conflict mask, grouping, release ranks) as the "
                         "one fused_select kernel, and the insert slots as "
                         "ring_slots")
    p1.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "on the CPU)")
    args = ap.parse_args(argv)
    return run_t0t1(args)


if __name__ == "__main__":
    main()
