"""Simulation launcher of the port (the ``t0t1`` and ``workload`` modes of
``repro.launch.simulate``).

  t0t1      reproduce the paper's §3.1 CERN study: a T0 -> T1 WAN bandwidth
            sweep, printing events, stale completions, interrupts, MB moved
            and windows per bandwidth; ``--adaptive-exec`` runs the
            monitoring-driven width ladder (``Engine.run_adaptive``)
  workload  simulate a training cell from each dry-run roofline JSON record
            in ``--results`` (``core/workload.py``)

``t0t1`` takes the host layer's options. ``--stream-trace CAP`` streams the
whole trace through a CAP-row ring (the line gains ``streamed=...
trace_drop=...``), ``--metrics-interval N`` prints a JSON metrics record
every N windows, ``--drain-every N`` sets the drain cadence.
``--checkpoint-dir D --checkpoint-every W`` saves the engine state every W
windows (``--checkpoint-keep`` newest kept), ``--resume`` continues from the
latest checkpoint in D, and ``--kill-after-window W`` SIGKILLs the process
right after the first committed checkpoint at window >= W (the crash
harness). A sweep of several bandwidths keeps one subdirectory ``D/bw_<bw>``
per bandwidth. The checkpoints are the reference's layout, so a run of
either package, on the card or the CPU, resumes in the other.

Runs on the CUDA card unless ``--device cpu`` is given:

    PYTHONPATH=src python -m repro_torch.launch.simulate t0t1 --device cuda
    PYTHONPATH=src python -m repro_torch.launch.simulate workload \
        --results results/dryrun --device cuda
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from repro_torch.core import monitoring as mon


T0T1_POOL_CAP = 1024


def exec_policy_args(args, pool_cap: int) -> dict:
    """``exec_cap`` or ``exec_policy`` build kwargs from the CLI knobs;
    ``pool_cap`` is the builder's, which the default ladder tops out at."""
    if not args.adaptive_exec:
        return dict(exec_cap=args.exec_cap)
    if args.exec_cap is not None:
        raise SystemExit(
            "--exec-cap and --adaptive-exec conflict: pass either a static "
            "width or a ladder (--exec-ladder), not both")
    from repro_torch.core.policy import ExecPolicy, default_ladder
    ladder = (tuple(args.exec_ladder) if args.exec_ladder
              else default_ladder(pool_cap))
    return dict(exec_policy=ExecPolicy(ladder=ladder))


def build_streams(args):
    """(engine kwargs, TraceStream or None) from the streaming options;
    the metrics records go to stdout."""
    kw, ts = {}, None
    if args.stream_trace is not None:
        ts = mon.TraceStream()
        kw.update(trace_cap=args.stream_trace, trace_stream=ts,
                  drain_every=args.drain_every)
    if args.metrics_interval is not None:
        kw.update(metrics_stream=mon.MetricsStream(
            interval=args.metrics_interval, out=sys.stdout),
            drain_every=args.drain_every)
    return kw, ts


def build_checkpointer(args, directory=None):
    """A SimCheckpointer from the checkpoint options, or None without
    ``--checkpoint-dir``; ``directory`` overrides it (a sweep point's)."""
    if args.checkpoint_dir is None:
        if (args.checkpoint_every or args.resume
                or args.kill_after_window is not None):
            raise SystemExit("--checkpoint-every/--resume/--kill-after-window "
                             "need --checkpoint-dir DIR")
        return None
    if args.kill_after_window is not None and not args.checkpoint_every:
        raise SystemExit("--kill-after-window needs --checkpoint-every W "
                         "(the kill fires after a committed checkpoint)")
    from repro_torch.checkpoint import SimCheckpointer
    return SimCheckpointer(directory or args.checkpoint_dir,
                           every=args.checkpoint_every,
                           keep=args.checkpoint_keep,
                           kill_after=args.kill_after_window)


def t0t1_scenario(bw: float, flows: int, agents: int,
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
                   pool_cap=T0T1_POOL_CAP, work_per_mb=2.0,
                   batched_dispatch=batched_dispatch, **spec_kw)


def run_t0t1(args) -> list[str]:
    from repro_torch.core import Engine

    # a sweep keeps one checkpoint subdirectory per bandwidth
    sweep_dirs = {bw: args.checkpoint_dir for bw in args.bandwidths}
    if args.checkpoint_dir is not None and len(args.bandwidths) > 1:
        sweep_dirs = {bw: os.path.join(args.checkpoint_dir, f"bw_{bw:g}")
                      for bw in args.bandwidths}
    lines = []
    for bw in args.bandwidths:
        ck = build_checkpointer(args, directory=sweep_dirs[bw])
        world, own, init_ev, spec = t0t1_scenario(
            bw, args.flows, args.agents, args.batched_dispatch,
            merge_mode=args.merge_mode, insert_mode=args.insert_mode,
            fused_select=args.fused_select,
            **exec_policy_args(args, T0T1_POOL_CAP))
        stream_kw, ts = build_streams(args)
        eng = Engine(world, own, init_ev, spec, device=args.device,
                     checkpointer=ck, **stream_kw)
        state, rung = None, None
        if args.resume:
            rec = eng.restore()
            state, rung = rec.state, rec.rung
            print(f"[resume] window {rec.step} from {sweep_dirs[bw]}",
                  flush=True)
        if args.adaptive_exec:
            st = eng.run_adaptive(max_windows=200_000, state=state,
                                  rung=rung)
        else:
            st = eng.run_local(max_windows=200_000, state=state)
        c = st.counters.sum(0).cpu()
        extra = ""
        if ts is not None:
            extra = (f" streamed={ts.n_streamed}"
                     f" trace_drop={int(c[mon.C_TRACE_DROP])}")
        line = (f"[t0t1] bw={bw:7.3f} MB/tick  "
                f"events={int(c[mon.C_EVENTS]):6d} "
                f"stale={int(c[mon.C_STALE]):5d} "
                f"interrupts={int(c[mon.C_INTERRUPTS]):5d} "
                f"MB={int(c[mon.C_MB_TRANSFERRED])} "
                f"windows={int(st.windows[0])}" + extra)
        print(line, flush=True)
        lines.append(line)
    return lines


def run_workload(args) -> list[str]:
    from repro_torch.core.workload import cell_from_roofline, simulate_training

    paths = sorted(glob.glob(os.path.join(args.results, "*.json")))
    if args.cell:
        paths = [p for p in paths if args.cell in p]
    lines = []
    for p in paths[: args.limit]:
        with open(p) as f:
            rec = json.load(f)
        if rec.get("status") != "ok":
            continue
        cell = cell_from_roofline(rec["roofline"], n_pods=2, n_steps=4)
        out = simulate_training(cell, device=args.device)
        line = (f"[workload] {rec['arch']} x {rec['shape']} x {rec['mesh']}: "
                f"sim={out['simulated_step_s']:.4f}s "
                f"analytic={out['analytic_step_s']:.4f}s "
                f"events={out['events']}")
        print(line, flush=True)
        lines.append(line)
    return lines


def _device_arg(p) -> None:
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "on the CPU)")


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
    p1.add_argument("--adaptive-exec", action="store_true",
                    help="monitoring-driven exec width (core/policy.py "
                         "ladder; Engine.run_adaptive) instead of a static "
                         "exec_cap")
    p1.add_argument("--exec-ladder", type=int, nargs="+", default=None,
                    help="explicit width ladder for --adaptive-exec "
                         "(default: policy.default_ladder(pool_cap))")
    p1.add_argument("--stream-trace", type=int, default=None, metavar="CAP",
                    help="stream the whole event trace to the host through "
                         "a CAP-row ring drained at window boundaries "
                         "(C_TRACE_DROP stays 0 for runs of any length; CAP "
                         "must be >= the exec width)")
    p1.add_argument("--metrics-interval", type=int, default=None,
                    metavar="N",
                    help="print a fleet metrics record as one JSON line "
                         "every N windows (the registry's counter names; a "
                         "final record always follows)")
    p1.add_argument("--drain-every", type=int, default=16, metavar="N",
                    help="trace-ring drain cadence in windows (a drain also "
                         "fires whenever the next window could overrun the "
                         "ring; default 16)")
    p1.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="directory of engine-state checkpoints (atomic "
                         "step_* subdirectories; enables the other "
                         "checkpoint options)")
    p1.add_argument("--checkpoint-every", type=int, default=0, metavar="W",
                    help="save a checkpoint every W windows (0: none)")
    p1.add_argument("--checkpoint-keep", type=int, default=3, metavar="N",
                    help="keep the newest N checkpoints (default 3)")
    p1.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in "
                         "--checkpoint-dir (byte-identical to a run that "
                         "never stopped)")
    p1.add_argument("--kill-after-window", type=int, default=None,
                    metavar="W",
                    help="SIGKILL this process right after the first "
                         "committed checkpoint at window >= W (the crash "
                         "harness; needs --checkpoint-every)")
    _device_arg(p1)
    p2 = sub.add_parser("workload")
    p2.add_argument("--results", default="results/dryrun")
    p2.add_argument("--cell", default="")
    p2.add_argument("--limit", type=int, default=5)
    _device_arg(p2)
    args = ap.parse_args(argv)
    return dict(t0t1=run_t0t1, workload=run_workload)[args.mode](args)


if __name__ == "__main__":
    main()
