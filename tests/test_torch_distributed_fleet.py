"""The port's fleet orchestrator and CLI across devices, with no JAX.

``Orchestrator`` runs the ``distributed`` and ``distributed_adaptive``
drivers (and ``auto`` over more than one device); a preemption shrinks the
run to the survivors and books ``RESHARD`` when the resumed attempt has
another device count, down to the ``min_devices`` floor, and the result
equals the run that never stopped. ``simulate distributed`` and ``simulate
run --devices 2`` run on ``--device cpu`` and refuse to run without a card
unless told.
"""
import os
import signal
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.checkpoint import SimCheckpointer  # noqa: E402
from repro_torch.core import Engine, TraceStream, run_sequential  # noqa: E402
from repro_torch.core import monitoring as mon  # noqa: E402
from repro_torch.core.policy import ExecPolicy  # noqa: E402
from repro_torch.fleet import (FleetError, FleetPolicy,  # noqa: E402
                               Orchestrator)
from repro_torch.launch import simulate  # noqa: E402

from test_torch_ensemble_port import assert_same, np_state  # noqa: E402
from test_torch_fleet import ROOT, build, engine, preempt_once  # noqa: E402

CPU3 = ["cpu"] * 3


def test_distributed_lanes_and_auto():
    built = build(4)
    want = np_state(engine(built).run_local())
    for driver in ("distributed", "auto"):
        res = Orchestrator(FleetPolicy(driver=driver)).run(built,
                                                          devices=CPU3)
        assert (res.driver, res.devices, res.attempts) == (
            "distributed", 3, 1)
        assert_same(np_state(res.state), want, driver)
    built_a = build(4, exec_policy=ExecPolicy(ladder=(4, 16)))
    res = Orchestrator().run(built_a, devices=CPU3[:2])
    assert res.driver == "distributed_adaptive"
    assert_same(np_state(res.state), np_state(engine(built_a).run_adaptive()))


def test_preemption_shrinks_to_survivors_and_reshards(tmp_path):
    built = build(4)
    want = np_state(engine(built).run_local())
    oracle = run_sequential(*built)[2]
    ts = TraceStream()
    pol = FleetPolicy(checkpoint_dir=str(tmp_path / "a"), checkpoint_every=4)
    res = Orchestrator(pol, trace_stream=ts, preempt=preempt_once(12, 2),
                       trace_cap=32, drain_every=4).run(built, devices=CPU3)
    assert (res.driver, res.devices, res.attempts) == ("distributed", 2, 2)
    assert res.counts == {"PREEMPT": 1, "RESUME": 1, "RESHARD": 1}
    assert_same(np_state(res.state), np_state(engine(
        built, trace_cap=32, trace_stream=TraceStream(),
        drain_every=4).run_local()))
    assert ts.merged() == oracle
    assert int(res.state.counters[:, mon.C_TRACE_DROP].sum()) == 0
    # down to one survivor: the one-device driver resumes the checkpoint
    pol = FleetPolicy(checkpoint_dir=str(tmp_path / "b"), checkpoint_every=4)
    res = Orchestrator(pol, preempt=preempt_once(8, 1)).run(built,
                                                             devices=CPU3)
    assert (res.driver, res.devices) == ("local", 1)
    assert res.counts == {"PREEMPT": 1, "RESUME": 1, "RESHARD": 1}
    assert_same(np_state(res.state), want)
    # the same device count again: a resume, no reshard
    pol = FleetPolicy(checkpoint_dir=str(tmp_path / "c"), checkpoint_every=4)
    res = Orchestrator(pol, preempt=preempt_once(8, 3)).run(built,
                                                             devices=CPU3)
    assert res.counts == {"PREEMPT": 1, "RESUME": 1, "RESHARD": 0}
    assert_same(np_state(res.state), want)
    # below the floor
    pol = FleetPolicy(checkpoint_dir=str(tmp_path / "d"), checkpoint_every=4,
                      min_devices=2)
    orch = Orchestrator(pol, preempt=preempt_once(8, 1))
    with pytest.raises(FleetError, match="device floor"):
        orch.run(built, devices=CPU3)
    assert orch.counts["PREEMPT"] == 1


def test_cli_distributed_and_run_devices(tmp_path):
    built = simulate.t0t1_scenario(0.5, 24, 4, pool_cap=512)
    st = Engine(*built, device="cpu").run_local(max_windows=200_000)
    c = st.counters.sum(0)
    line = simulate.main(["distributed", "--device", "cpu", "--devices", "2",
                          "--agents-per-device", "2"])
    assert line == [
        f"[distributed] agents=4 devices=2 events={int(c[mon.C_EVENTS])} "
        f"windows={int(st.windows[0])} "
        f"remote_msgs={int(c[mon.C_MSGS_REMOTE])}"]
    # streamed through a ring, killed by SIGKILL after a checkpoint, and
    # resumed on another device count: the stream check holds the trace
    ck = ["--device", "cpu", "--flows", "8", "--exec-cap", "16",
          "--stream-trace", "16",
          "--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "8"]
    dead = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.simulate", "distributed",
         "--devices", "2", "--agents-per-device", "2", *ck,
         "--kill-after-window", "16"], capture_output=True, text=True,
        timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert dead.returncode == -signal.SIGKILL, dead.stderr[-2000:]
    assert SimCheckpointer(str(tmp_path / "ck")).latest_step() == 16
    with pytest.raises(SystemExit, match="--resume and --migrate"):
        simulate.main(["distributed", "--resume", "--migrate", *ck])
    resumed = simulate.main(["distributed", "--devices", "4",
                             "--agents-per-device", "1", "--resume",
                             "--stream-check", *ck])
    whole = simulate.main(["distributed", "--device", "cpu", "--devices",
                           "4", "--agents-per-device", "1", "--flows", "8",
                           "--exec-cap", "16"])
    assert resumed[0].startswith(whole[0] + " streamed=")
    assert resumed[0].endswith(" trace_drop=0")
    assert resumed[1].startswith("[stream-check] OK")
    line = simulate.main(["run", "t0t1", "--device", "cpu", "--devices", "2",
                          "--set", "n_flows=8"])[0]
    whole = simulate.main(["run", "t0t1", "--device", "cpu", "--set",
                           "n_flows=8"])[0]
    assert line.startswith("[run] t0t1 driver=distributed devices=2 ")
    assert line.split("devices=2 ")[1] == whole.split("devices=1 ")[1]


def test_distributed_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["distributed"], ["distributed", "--devices", "2"],
                 ["run", "t0t1", "--devices", "2"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            simulate.main(argv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Orchestrator(FleetPolicy(driver="distributed")).run(build(2))
