"""Simulation launcher of the port (the modes of ``repro.launch.simulate``).

  t0t1      reproduce the paper's §3.1 CERN study: a T0 -> T1 WAN bandwidth
            sweep, printing events, stale completions, interrupts, MB moved
            and windows per bandwidth; ``--adaptive-exec`` runs the
            monitoring-driven width ladder (``Engine.run_adaptive``)
  workload  simulate a training cell from each dry-run roofline JSON record
            in ``--results`` (``core/workload.py``)
  distributed
            the T0/T1 scenario across ``--devices N`` shards
            (``Engine.run_distributed``, default 8, the reference CLI's
            forced host devices), ``--agents-per-device`` agents each;
            ``--migrate`` moves the seeded agent's LPs to the other end of
            the fleet through the exchange first, ``--adaptive-exec`` runs
            the lockstep width ladder (``run_distributed_adaptive``). The
            shards share ``--device``'s card(s) when there are fewer cards
            than shards: that is not a multi-card run
  ensemble  a Monte Carlo failure-farm ensemble: ``--replicas`` seeds in one
            ``Engine.run_ensemble`` (one JSON summary record, then the
            ``[ensemble]`` line)
  run       a catalog scenario (``scenarios/catalog.py``; ``--list`` prints
            the catalog) through ``fleet.Orchestrator``: checkpoints,
            injected (``--preempt-at-window``) and SIGKILL
            (``--kill-after-window``) preemptions, resume, retry caps;
            ``--devices N`` runs on N shards of ``--device``'s kind (the
            distributed drivers above one), and a preemption shrinks the
            run to the survivors

``t0t1`` and ``distributed`` take the host layer's options.
``--stream-trace CAP`` streams the whole trace through a CAP-row ring (the
line gains ``streamed=... trace_drop=...``), ``--metrics-interval N``
prints a JSON metrics record every N windows, ``--drain-every N`` sets the
drain cadence.
``--checkpoint-dir D --checkpoint-every W`` saves the engine state every W
windows (``--checkpoint-keep`` newest kept), ``--resume`` continues from the
latest checkpoint in D, and ``--kill-after-window W`` SIGKILLs the process
right after the first committed checkpoint at window >= W (the crash
harness). A sweep of several bandwidths keeps one subdirectory ``D/bw_<bw>``
per bandwidth. The checkpoints are the reference's layout and hold the
unpadded state, so a run of either package, on the card or the CPU, resumes
in the other, and ``distributed --resume`` on any number of shards.

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
    """(engine kwargs, TraceStream or None, MetricsStream or None) from the
    streaming options; the metrics records go to stdout."""
    kw, ts, ms = {}, None, None
    if args.stream_trace is not None:
        ts = mon.TraceStream()
        kw.update(trace_cap=args.stream_trace, trace_stream=ts,
                  drain_every=args.drain_every)
    if args.metrics_interval is not None:
        ms = mon.MetricsStream(interval=args.metrics_interval,
                               out=sys.stdout)
        kw.update(metrics_stream=ms, drain_every=args.drain_every)
    return kw, ts, ms


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
                  batched_dispatch: bool = True,
                  pool_cap: int = T0T1_POOL_CAP, **spec_kw):
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
                   pool_cap=pool_cap, work_per_mb=2.0,
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
        stream_kw, ts, _ms = build_streams(args)
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


def run_distributed(args) -> list[str]:
    import numpy as np

    from repro_torch.core import Engine, merged_engine_trace
    from repro_torch.launch.mesh import make_sim_mesh

    mesh = make_sim_mesh(args.devices, args.device)
    n_dev = len(mesh)
    n = n_dev * args.agents_per_device
    pool_cap = 512
    world, own, init_ev, spec = t0t1_scenario(
        0.5, args.flows, n, args.batched_dispatch, pool_cap=pool_cap,
        merge_mode=args.merge_mode, insert_mode=args.insert_mode,
        fused_select=args.fused_select, **exec_policy_args(args, pool_cap))
    if args.stream_check and args.stream_trace is None:
        raise SystemExit("--stream-check needs --stream-trace CAP")
    ck = build_checkpointer(args)
    if args.resume and args.migrate:
        raise SystemExit("--resume and --migrate conflict: the checkpoint "
                         "already contains the (possibly migrated) state")
    stream_kw, ts, _ms = build_streams(args)
    eng = Engine(world, own, init_ev, spec, device=mesh[0], checkpointer=ck,
                 **stream_kw)
    state = None
    if args.migrate and n > 1:
        # move the agent that holds the seeded events (the generator LP's
        # owner) to the other end of the fleet, so its pool ships through
        # the exchange, then continue from the migrated state
        st0 = eng.init_state()
        la = st0.world.lp_agent[0].cpu().numpy()
        src = int(st0.pool.valid.sum(1).cpu().numpy().argmax())
        dst = 0 if src != 0 else n - 1
        new_la = np.where(la == src, dst,
                          np.where(la == dst, src, la)).astype(np.int32)
        state = eng.apply_placement_distributed(st0, new_la, mesh)
    run_state, run_rung = state, None
    if args.resume:
        rec = eng.restore()
        run_state, run_rung = rec.state, rec.rung
        print(f"[resume] window {rec.step} from {args.checkpoint_dir} "
              f"onto {n_dev} devices", flush=True)
    if args.adaptive_exec:
        st = eng.run_distributed_adaptive(mesh, max_windows=200_000,
                                          state=run_state, rung=run_rung)
    else:
        st = eng.run_distributed(mesh, max_windows=200_000, state=run_state)
    c = st.counters.sum(0).cpu()
    extra = ""
    if args.migrate:
        extra = (f" migrate_out={int(c[mon.C_MIGRATE_OUT])}"
                 f" migrate_in={int(c[mon.C_MIGRATE_IN])}")
    if args.adaptive_exec:
        extra += f" rungs={sorted(set(eng.adaptive_rungs))}"
    if ts is not None:
        extra += (f" streamed={ts.n_streamed}"
                  f" trace_drop={int(c[mon.C_TRACE_DROP])}")
    lines = [f"[distributed] agents={n} devices={n_dev} "
             f"events={int(c[mon.C_EVENTS])} "
             f"windows={int(st.windows[0])} "
             f"remote_msgs={int(c[mon.C_MSGS_REMOTE])}" + extra]
    print(lines[-1], flush=True)
    if args.stream_check:
        # the streamed (perhaps killed and resumed) trace dropped nothing,
        # outgrew the ring, and equals an unstreamed run's from the start
        # (or the migrated state), with a trace buffer that holds it all
        drop = int(c[mon.C_TRACE_DROP])
        if drop:
            raise SystemExit(f"stream-check FAILED: C_TRACE_DROP={drop}")
        tn = st.trace_n.cpu().numpy()
        if int(tn.max()) <= args.stream_trace:
            raise SystemExit(
                f"stream-check vacuous: per-agent trace_n max {int(tn.max())}"
                f" never exceeded the ring cap {args.stream_trace} - lower "
                f"--stream-trace or raise the event count")
        ref_eng = Engine(world, own, init_ev, spec, trace_cap=1 << 16,
                         device=mesh[0])
        if args.adaptive_exec:
            ref = ref_eng.run_distributed_adaptive(mesh, max_windows=200_000,
                                                   state=state)
        else:
            ref = ref_eng.run_distributed(mesh, max_windows=200_000,
                                          state=state)
        want = merged_engine_trace(ref.trace.cpu().numpy(),
                                   ref.trace_n.cpu().numpy())
        got = ts.merged()
        if got != want:
            raise SystemExit(
                f"stream-check FAILED: streamed trace ({len(got)} rows) != "
                f"in-device reference ({len(want)} rows)")
        lines.append(f"[stream-check] OK: {len(got)} rows streamed through "
                     f"a {args.stream_trace}-row ring == reference, "
                     f"trace_drop=0")
        print(lines[-1], flush=True)
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


def run_ensemble(args) -> list[str]:
    import numpy as np

    from repro_torch.core import Engine
    from repro_torch.scenarios.failures import build_failure_scenario

    built, _info = build_failure_scenario(n_farms=args.farms,
                                          pool_cap=args.pool_cap)
    ms = mon.MetricsStream(interval=1_000_000, out=sys.stdout)
    eng = Engine(*built, metrics_stream=ms, device=args.device)
    seeds = np.arange(args.seed0, args.seed0 + args.replicas, dtype=np.int32)
    eng.run_ensemble(seeds)
    ev_stats = ms.latest["per_replica"]["EVENTS"]
    fail_stats = ms.latest["per_replica"]["CPU_FAILS"]
    line = (f"[ensemble] replicas={args.replicas} farms={args.farms} "
            f"windows={ms.latest['windows']} "
            f"events/replica min={ev_stats['min']} "
            f"mean={ev_stats['mean']:.1f} max={ev_stats['max']} "
            f"fails/replica min={fail_stats['min']} "
            f"max={fail_stats['max']}")
    print(line, flush=True)
    return [json.dumps(ms.latest), line]


def run_catalog(args) -> list[str]:
    import numpy as np

    from repro_torch.scenarios import catalog

    if args.list:
        lines = []
        for name in catalog.names():
            sd = catalog.get(name)
            lines.append(f"{name:15s} [{sd.driver}] {sd.doc}")
            defaults = " ".join(f"{k}={v}" for k, v in sd.params)
            if defaults:
                lines.append(f"{'':15s} params: {defaults}")
        print("\n".join(lines), flush=True)
        return lines
    if args.name is None:
        raise SystemExit("simulate run: pass a scenario name (or --list)")
    overrides = {}
    for item in args.set:
        key, sep, value = item.partition("=")
        if not sep or not key:
            raise SystemExit(f"--set expects K=V, got {item!r}")
        overrides[key] = value
    try:
        sd = catalog.get(args.name)
        built, params = sd.resolve(overrides)
    except catalog.CatalogError as e:
        raise SystemExit(str(e)) from None

    from repro_torch.fleet import FleetPolicy, Orchestrator
    from repro_torch.launch.mesh import make_sim_mesh

    devices = make_sim_mesh(args.devices or 1, args.device)

    preempt = None
    if args.preempt_at_window is not None:
        if args.preempt_survivors is None:
            raise SystemExit("--preempt-at-window needs --preempt-survivors K")
        if args.checkpoint_dir is None:
            raise SystemExit("--preempt-at-window needs --checkpoint-dir DIR "
                             "(the resume path requires checkpoints)")

        def preempt(window, attempt, *, _w=args.preempt_at_window,
                    _k=args.preempt_survivors):
            # one injected shard loss: the first attempt dies once it
            # reaches window _w, leaving _k survivors; later attempts run out
            return _k if attempt == 0 and window >= _w else None

    if args.stream_check and args.stream_trace is None:
        raise SystemExit("--stream-check needs --stream-trace CAP")
    _stream_kw, ts, ms = build_streams(args)
    pol = FleetPolicy(
        driver=sd.driver if sd.driver != "auto" else args.driver,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        checkpoint_keep=args.checkpoint_keep,
        kill_after=args.kill_after_window,
        max_windows=args.max_windows,
        max_retries=args.max_retries,
        backoff=args.backoff,
        min_devices=args.min_devices)
    orch = Orchestrator(pol, trace_stream=ts, metrics_stream=ms,
                        preempt=preempt,
                        trace_cap=args.stream_trace or 0,
                        drain_every=args.drain_every)
    seeds = None
    if sd.driver == "ensemble":
        seeds = np.arange(params["seed0"],
                          params["seed0"] + params["replicas"],
                          dtype=np.int32)
    res = orch.run(built, devices=devices, seeds=seeds)

    st = res.state
    cn = st.counters.cpu().numpy()  # (A, N), or (R, A, N) for ensembles
    c = cn.sum(axis=tuple(range(cn.ndim - 1)))
    lines = [f"[run] {args.name} driver={res.driver} devices={res.devices} "
             f"attempts={res.attempts} events={int(c[mon.C_EVENTS])} "
             f"windows={int(st.windows.reshape(-1)[0])} "
             f"preempt={res.counts['PREEMPT']} "
             f"resume={res.counts['RESUME']} "
             f"reshard={res.counts['RESHARD']}"]
    print(lines[-1], flush=True)
    if args.stream_check:
        # the streamed (perhaps preempted and resumed) trace dropped
        # nothing, outgrew the ring, and equals a run that was never
        # interrupted, with a trace buffer that holds it all
        from repro_torch.core import Engine, merged_engine_trace
        drop = int(c[mon.C_TRACE_DROP])
        if drop:
            raise SystemExit(f"stream-check FAILED: C_TRACE_DROP={drop}")
        tn = st.trace_n.cpu().numpy()
        if int(tn.max()) <= args.stream_trace:
            raise SystemExit(
                f"stream-check vacuous: per-agent trace_n max {int(tn.max())}"
                f" never exceeded the ring cap {args.stream_trace}")
        ref_eng = Engine(*built, trace_cap=1 << 16, device=devices[0])
        mesh = devices[: res.devices]
        if res.driver == "local":
            ref = ref_eng.run_local(pol.max_windows)
        elif res.driver == "adaptive":
            ref = ref_eng.run_adaptive(pol.max_windows)
        elif res.driver == "distributed_adaptive":
            ref = ref_eng.run_distributed_adaptive(mesh, pol.max_windows)
        else:
            ref = ref_eng.run_distributed(mesh, pol.max_windows)
        want = merged_engine_trace(ref.trace.cpu().numpy(),
                                   ref.trace_n.cpu().numpy())
        got = ts.merged()
        if got != want:
            raise SystemExit(
                f"stream-check FAILED: streamed trace ({len(got)} rows) != "
                f"uninterrupted reference ({len(want)} rows)")
        lines.append(f"[stream-check] OK: {len(got)} rows streamed through a "
                     f"{args.stream_trace}-row ring across {res.attempts} "
                     f"attempt(s) == uninterrupted reference, trace_drop=0")
        print(lines[-1], flush=True)
    return lines


def _stream_args(p) -> None:
    p.add_argument("--stream-trace", type=int, default=None, metavar="CAP",
                   help="stream the whole event trace to the host through "
                        "a CAP-row ring drained at window boundaries "
                        "(C_TRACE_DROP stays 0 for runs of any length; CAP "
                        "must be >= the exec width)")
    p.add_argument("--metrics-interval", type=int, default=None,
                   metavar="N",
                   help="print a fleet metrics record as one JSON line "
                        "every N windows (the registry's counter names; a "
                        "final record always follows)")
    p.add_argument("--drain-every", type=int, default=16, metavar="N",
                   help="trace-ring drain cadence in windows (a drain also "
                        "fires whenever the next window could overrun the "
                        "ring; default 16)")


def _checkpoint_args(p) -> None:
    p.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                   help="directory of engine-state checkpoints (atomic "
                        "step_* subdirectories; enables the other "
                        "checkpoint options)")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="W",
                   help="save a checkpoint every W windows (0: none)")
    p.add_argument("--checkpoint-keep", type=int, default=3, metavar="N",
                   help="keep the newest N checkpoints (default 3)")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint in "
                        "--checkpoint-dir (byte-identical to a run that "
                        "never stopped; distributed: on any device count)")
    p.add_argument("--kill-after-window", type=int, default=None,
                   metavar="W",
                   help="SIGKILL this process right after the first "
                        "committed checkpoint at window >= W (the crash "
                        "harness; needs --checkpoint-every)")


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
    _stream_args(p1)
    _checkpoint_args(p1)
    _device_arg(p1)
    p2 = sub.add_parser("workload")
    p2.add_argument("--results", default="results/dryrun")
    p2.add_argument("--cell", default="")
    p2.add_argument("--limit", type=int, default=5)
    _device_arg(p2)
    p3 = sub.add_parser("distributed")
    p3.add_argument("--devices", type=int, default=8, metavar="N",
                    help="shards of --device's kind (default 8, the "
                         "reference CLI's forced host devices); they spread "
                         "over the cards there are and share them when "
                         "there are fewer cards")
    p3.add_argument("--agents-per-device", type=int, default=2,
                    help="agent rows in each shard (agents = devices x "
                         "this; the engine pads uneven packings itself)")
    p3.add_argument("--migrate", action="store_true",
                    help="move the first and last agents' LP placements "
                         "through the exchange before running, and report "
                         "MIGRATE_OUT/MIGRATE_IN")
    p3.add_argument("--adaptive-exec", action="store_true",
                    help="lockstep monitoring-driven exec width "
                         "(Engine.run_distributed_adaptive) instead of a "
                         "static exec_cap")
    p3.add_argument("--exec-ladder", type=int, nargs="+", default=None,
                    help="explicit width ladder for --adaptive-exec "
                         "(default: policy.default_ladder(pool_cap))")
    p3.add_argument("--exec-cap", type=int, default=None,
                    help="per-window compacted execution cap "
                         "(default min(pool_cap, 256))")
    p3.add_argument("--batched-dispatch", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="grouped batched handler dispatch (engine step 4); "
                         "--no-batched-dispatch runs the sequential fold")
    p3.add_argument("--merge-mode", choices=("delta", "dense"),
                    default="delta",
                    help="batched merge: per-row delta scatters (default) "
                         "or the whole-table reference merge")
    p3.add_argument("--insert-mode", choices=("ring", "ref"), default="ring",
                    help="event-pool lifecycle: free-list ring (default) or "
                         "the O(pool_cap) reference rank scan")
    p3.add_argument("--fused-select", action="store_true",
                    help="run the window front end as the one fused_select "
                         "kernel, and the insert slots as ring_slots")
    p3.add_argument("--flows", type=int, default=24,
                    help="generator flow count (the event volume: raise it "
                         "to push a run past the trace ring)")
    _stream_args(p3)
    p3.add_argument("--stream-check", action="store_true",
                    help="after the streamed run, check C_TRACE_DROP == 0, "
                         "that the trace outgrew the ring, and that the "
                         "streamed trace equals an unstreamed run's; exit "
                         "nonzero on any mismatch")
    _checkpoint_args(p3)
    _device_arg(p3)
    p4 = sub.add_parser("ensemble")
    p4.add_argument("--replicas", type=int, default=128,
                    help="Monte Carlo replicas in one run_ensemble "
                         "(default 128)")
    p4.add_argument("--farms", type=int, default=4,
                    help="failure-scenario farm count (scenario size knob)")
    p4.add_argument("--pool-cap", type=int, default=256)
    p4.add_argument("--seed0", type=int, default=0,
                    help="first replica seed (replica r runs seed0 + r)")
    _device_arg(p4)
    p5 = sub.add_parser("run")
    p5.add_argument("name", nargs="?", default=None,
                    help="catalog scenario name (see --list)")
    p5.add_argument("--list", action="store_true",
                    help="print the scenario catalog (names, drivers, "
                         "declared parameters) and exit")
    p5.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="override a declared scenario parameter (repeat "
                         "for several; values are coerced to the default's "
                         "type, and undeclared keys are an error)")
    p5.add_argument("--devices", type=int, default=None, metavar="N",
                    help="start on N shards of --device's kind (default 1; "
                         "shards spread over the cards there are and share "
                         "them when there are fewer cards)")
    p5.add_argument("--driver",
                    choices=("auto", "local", "adaptive", "distributed",
                             "distributed_adaptive"), default="auto",
                    help="engine driver (auto picks distributed/adaptive "
                         "from the device count and the spec's exec "
                         "policy; ensemble catalog entries force their own "
                         "driver)")
    p5.add_argument("--max-windows", type=int, default=10_000, metavar="W",
                    help="per-attempt window budget (default 10000)")
    p5.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="checkpoint directory (enables the resume path; "
                         "committed checkpoints found there are resumed: "
                         "the restart-after-SIGKILL contract)")
    p5.add_argument("--checkpoint-every", type=int, default=8, metavar="W",
                    help="save every W windows (default 8; 0 disables)")
    p5.add_argument("--checkpoint-keep", type=int, default=3, metavar="N",
                    help="retain the newest N checkpoints (default 3)")
    p5.add_argument("--kill-after-window", type=int, default=None,
                    metavar="W",
                    help="SIGKILL the process right after the first "
                         "committed checkpoint at window >= W (the crash "
                         "lane; rerun the same command to resume)")
    p5.add_argument("--max-retries", type=int, default=3, metavar="N",
                    help="preemption retry cap before FleetError (default 3)")
    p5.add_argument("--min-devices", type=int, default=1, metavar="N",
                    help="device floor: fewer survivors fail instead of "
                         "resuming (default 1)")
    p5.add_argument("--backoff", type=float, default=0.0, metavar="S",
                    help="base retry backoff seconds (exponential, capped; "
                         "default 0 = immediate)")
    p5.add_argument("--preempt-at-window", type=int, default=None,
                    metavar="W",
                    help="inject one preemption once the first attempt "
                         "reaches window W (needs --preempt-survivors and "
                         "--checkpoint-dir)")
    p5.add_argument("--preempt-survivors", type=int, default=None,
                    metavar="K",
                    help="surviving device count after the injected "
                         "preemption (the fleet shrinks to the first K)")
    _stream_args(p5)
    p5.add_argument("--stream-check", action="store_true",
                    help="after the run, check C_TRACE_DROP == 0, that the "
                         "trace outgrew the ring, and that the streamed "
                         "trace equals an uninterrupted run's; exit "
                         "nonzero on any mismatch")
    _device_arg(p5)
    args = ap.parse_args(argv)
    return dict(t0t1=run_t0t1, workload=run_workload,
                distributed=run_distributed, ensemble=run_ensemble,
                run=run_catalog)[args.mode](args)


if __name__ == "__main__":
    main()
