"""The port's fleet orchestrator on one device, with no JAX (the lanes of
tests/test_fleet.py that need one device).

``repro_torch.fleet.Orchestrator`` runs a built scenario through
``run_local``, ``run_adaptive`` or ``run_ensemble`` and survives
preemption: an injected probe or a SIGKILL of the process. A resumed run's
state is byte-identical to the uninterrupted run's, the fleet counters are
booked on the host only, and the retry cap, the backoff, the device floor
and the ``fleet.json`` sidecar behave as the reference's. The lanes across
devices are tested in test_torch_distributed_fleet.py.
"""
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.checkpoint import SimCheckpointer  # noqa: E402
from repro_torch.core import (Engine, MetricsStream, TraceStream,  # noqa: E402
                              merged_engine_trace, run_sequential)
from repro_torch.core import monitoring as mon  # noqa: E402
from repro_torch.core.policy import ExecPolicy  # noqa: E402
from repro_torch.fleet import (FleetError, FleetPolicy,  # noqa: E402
                               Orchestrator, PreemptionError)
from repro_torch.launch import simulate  # noqa: E402
from repro_torch.scenarios import catalog  # noqa: E402

from test_torch_ensemble_port import assert_same, np_state  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = [torch.device("cpu")]


def build(n_agents, *, exec_cap=16, exec_policy=None):
    kw = dict(exec_policy=exec_policy) if exec_policy else dict(
        exec_cap=exec_cap)
    return simulate.t0t1_scenario(2.0, 12, n_agents, **kw)


def engine(built, **kw):
    return Engine(*built, device="cpu", **kw)


def assert_states_equal(got, want, what="state"):
    assert_same(np_state(got), np_state(want), what)


def preempt_once(at_window, survivors):
    """A probe that stops the first attempt once it reaches ``at_window``."""
    def probe(window, attempt):
        return survivors if attempt == 0 and window >= at_window else None
    return probe


def fleet_rows_zero(state):
    return int(state.counters[..., list(mon.FLEET_COUNTERS)].sum()) == 0


@pytest.fixture(scope="module")
def oracle():
    return run_sequential(*build(1))[2]


def test_policy_validation_and_preemption_error():
    with pytest.raises(FleetError, match="unknown driver"):
        FleetPolicy(driver="bogus")
    with pytest.raises(FleetError, match="min_devices"):
        FleetPolicy(min_devices=0)
    with pytest.raises(FleetError, match="max_retries"):
        FleetPolicy(max_retries=-1)
    with pytest.raises(FleetError, match="checkpoint_every"):
        FleetPolicy(checkpoint_every=-1)
    e = PreemptionError(3, at_window=17)
    assert e.survivors == 3 and e.at_window == 17
    assert "window 17" in str(e)


def test_orchestrator_matches_engine_drivers(oracle):
    built = build(3)
    res = Orchestrator().run(built, devices=CPU)
    assert res.driver == "local" and res.attempts == 1
    assert res.counts == {"PREEMPT": 0, "RESUME": 0, "RESHARD": 0}
    assert_states_equal(res.state, engine(built).run_local())
    built_a = build(3, exec_policy=ExecPolicy(ladder=(4, 16)))
    res_a = Orchestrator().run(built_a, devices=CPU)
    assert res_a.driver == "adaptive"
    assert_states_equal(res_a.state, engine(built_a).run_adaptive())
    # streamed through the orchestrator: the oracle's trace, nothing dropped
    ts = TraceStream()
    res_s = Orchestrator(trace_stream=ts, trace_cap=32, drain_every=4).run(
        build(4), devices=CPU)
    assert ts.merged() == oracle
    assert int(res_s.state.counters[:, mon.C_TRACE_DROP].sum()) == 0


def test_injected_preemption_resume_byte_identical(oracle, tmp_path):
    built = build(4)
    ref_ms = MetricsStream(interval=4)
    ref = engine(built, trace_cap=32, trace_stream=TraceStream(),
                 metrics_stream=ref_ms, drain_every=4).run_local()
    ts, ms = TraceStream(), MetricsStream(interval=4)
    pol = FleetPolicy(checkpoint_dir=str(tmp_path), checkpoint_every=4)
    res = Orchestrator(pol, trace_stream=ts, metrics_stream=ms,
                       preempt=preempt_once(12, 1), trace_cap=32,
                       drain_every=4).run(built, devices=CPU)
    assert res.attempts == 2
    assert res.counts == {"PREEMPT": 1, "RESUME": 1, "RESHARD": 0}
    assert_states_equal(res.state, ref)
    assert ts.merged() == oracle
    assert fleet_rows_zero(res.state)
    # the records continue the uninterrupted run's; only the fleet books
    # differ
    fleet = {"PREEMPT", "RESUME", "RESHARD"}
    assert len(ms.lines) == len(ref_ms.lines)

    def strip(rec):
        return dict(rec, counters={k: v for k, v in rec["counters"].items()
                                   if k not in fleet})
    assert [strip(r) for r in ms.lines] == [strip(r) for r in ref_ms.lines]
    assert ms.latest["counters"]["PREEMPT"] == 1
    assert ms.latest["counters"]["RESUME"] == 1
    with open(tmp_path / "fleet.json") as f:
        assert json.load(f) == {"n_devices": 1, "clean": True,
                                "counts": res.counts}


def test_preemption_floor_retry_cap_and_backoff(tmp_path):
    built = build(3)
    ref = engine(built).run_local()
    # before the first checkpoint: a fresh restart, no RESUME
    pol = FleetPolicy(checkpoint_dir=str(tmp_path / "a"),
                      checkpoint_every=50)
    res = Orchestrator(pol, preempt=preempt_once(2, 1)).run(built,
                                                             devices=CPU)
    assert res.attempts == 2
    assert res.counts == {"PREEMPT": 1, "RESUME": 0, "RESHARD": 0}
    assert_states_equal(res.state, ref)
    # no survivor: below the device floor
    pol = FleetPolicy(checkpoint_dir=str(tmp_path / "b"), checkpoint_every=4)
    orch = Orchestrator(pol, preempt=preempt_once(4, 0))
    with pytest.raises(FleetError, match="device floor"):
        orch.run(build(2), devices=CPU)
    assert orch.counts["PREEMPT"] == 1
    # preempted every attempt: the cap
    pol = FleetPolicy(checkpoint_dir=str(tmp_path / "c"), checkpoint_every=4,
                      max_retries=2)
    orch = Orchestrator(pol, preempt=lambda w, a: 1 if w >= 4 else None)
    with pytest.raises(FleetError, match="retry cap"):
        orch.run(build(2), devices=CPU)
    assert orch.counts["PREEMPT"] == 3
    # exponential, capped, only between attempts
    slept = []
    pol = FleetPolicy(checkpoint_dir=str(tmp_path / "d"), checkpoint_every=4,
                      max_retries=3, backoff=2.0, backoff_cap=3.0)
    res = Orchestrator(pol, sleep=slept.append,
                       preempt=lambda w, a: 1 if a < 2 and w >= 4 else None
                       ).run(build(2), devices=CPU)
    assert res.attempts == 3 and slept == [2.0, 3.0]


def test_sidecar_restart_discovery(tmp_path):
    """A process that died after committed checkpoints left an unclean
    ``fleet.json``: the next start books the death, the old books and the
    resume, and counts the device change as a reshard."""
    built = build(3)
    ref = engine(built).run_local()

    class Die(RuntimeError):
        pass

    def die(window, _state):
        if window >= 8:
            raise Die

    with pytest.raises(Die):
        engine(built, checkpointer=SimCheckpointer(str(tmp_path), every=4),
               window_hook=die).run_local()
    with open(tmp_path / "fleet.json", "w") as f:
        json.dump({"n_devices": 2, "clean": False,
                   "counts": {"PREEMPT": 1, "RESUME": 1, "RESHARD": 0}}, f)
    res = Orchestrator(FleetPolicy(checkpoint_dir=str(tmp_path),
                                   checkpoint_every=4)).run(built, devices=CPU)
    assert res.attempts == 1
    assert res.counts == {"PREEMPT": 2, "RESUME": 2, "RESHARD": 1}
    assert_states_equal(res.state, ref)
    with open(tmp_path / "fleet.json") as f:
        assert json.load(f)["clean"] is True


def test_ensemble_driver_and_catalog_entry():
    built = build(2)
    seeds = np.arange(1, 4, dtype=np.int32)
    res = Orchestrator(FleetPolicy(driver="ensemble")).run(
        built, devices=CPU, seeds=seeds)
    assert res.driver == "ensemble" and res.attempts == 1
    assert_states_equal(res.state, engine(built).run_ensemble(seeds))
    with pytest.raises(FleetError, match="seed vector"):
        Orchestrator(FleetPolicy(driver="ensemble")).run(built, devices=CPU)
    line = simulate.main(["run", "ensemble_farm", "--device", "cpu",
                          "--set", "replicas=3", "--set", "n_bursts=2"])
    out = engine(catalog.resolve("ensemble_farm", {"n_bursts": "2"})[0]
                 ).run_ensemble(np.arange(1, 4))
    assert line == [
        f"[run] ensemble_farm driver=ensemble devices=1 attempts=1 "
        f"events={int(out.counters[..., mon.C_EVENTS].sum())} "
        f"windows={int(out.windows[0, 0])} preempt=0 resume=0 reshard=0"]


def test_sigkill_lane_through_the_cli(tmp_path):
    """``simulate run t0t1 --kill-after-window`` dies by SIGKILL after a
    committed checkpoint; the same command without the kill finds the
    unclean sidecar, books the preemption, resumes, and prints the
    uninterrupted run's counts."""
    base = ["run", "t0t1", "--device", "cpu", "--set", "n_flows=8",
            "--checkpoint-every", "8"]
    whole = simulate.main(base)[0]
    ck = ["--checkpoint-dir", str(tmp_path)]
    dead = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.simulate", *base, *ck,
         "--kill-after-window", "24"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert dead.returncode == -signal.SIGKILL, dead.stderr[-2000:]
    assert "[run]" not in dead.stdout
    with open(tmp_path / "fleet.json") as f:
        assert json.load(f)["clean"] is False
    assert SimCheckpointer(str(tmp_path)).latest_step() >= 24
    resumed = simulate.main([*base, *ck])[0]
    assert resumed == whole.replace("preempt=0 resume=0",
                                    "preempt=1 resume=1")
    # the streamed trace of a preempted run equals the oracle's
    line = simulate.main(["run", "t0t1", "--device", "cpu", "--set",
                          "n_flows=8", "--set", "exec_cap=8",
                          "--checkpoint-dir", str(tmp_path / "s"),
                          "--checkpoint-every", "4", "--preempt-at-window",
                          "12", "--preempt-survivors", "1", "--stream-trace",
                          "16", "--stream-check"])
    assert "preempt=1 resume=1" in line[0]
    assert line[1].startswith("[stream-check] OK:")
    assert "across 2 attempt(s)" in line[1]
    built = catalog.resolve("t0t1", {"n_flows": "8"})[0]
    st = engine(built, trace_cap=4096).run_local()
    assert merged_engine_trace(st.trace, st.trace_n) == \
        run_sequential(*built)[2]


def test_entry_points_need_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Orchestrator().run(build(1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Orchestrator(FleetPolicy(driver="ensemble")).run(build(1), seeds=[0])
    for argv in (["ensemble", "--replicas", "2"], ["run", "t0t1"],
                 ["run", "ensemble_farm"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            simulate.main(argv)
