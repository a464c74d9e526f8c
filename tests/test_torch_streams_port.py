"""The port's streamed trace against its own buffered run and oracle, and
its crash harness, with no JAX.

A hypothesis property draws the drain cadence, the ring (at least the exec
width), the width, a static or adaptive run and the metrics interval, and
holds the streamed trace equal to the buffered run's and the oracle's, the
ring wrapped and nothing dropped, the final metrics record equal to the
counters. (The reference's ``tests/test_monitoring.py`` states this
property; hypothesis binds its positional strategy to the fixture argument,
so that test errors at setup.) The crash harness kills ``simulate t0t1``
after a checkpoint, resumes it, and gets the uninterrupted run's line.
"""
import os
import signal
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
hyp = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as hs  # noqa: E402

from repro_torch.core import Engine, merged_engine_trace  # noqa: E402
from repro_torch.core import monitoring as mon  # noqa: E402
from repro_torch.core import run_sequential  # noqa: E402
from repro_torch.core.policy import ExecPolicy  # noqa: E402
from repro_torch.launch import simulate  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 4 agents at 8 MB/tick, 24 flows: every agent's trace outgrows a 24-row ring
SCEN = (8.0, 24, 4)


@pytest.fixture(scope="module")
def oracle():
    return run_sequential(*simulate.t0t1_scenario(*SCEN))[2]


@settings(max_examples=5, deadline=None, derandomize=True)
@given(p=hs.fixed_dictionaries(dict(
    drain=hs.integers(1, 9), width=hs.sampled_from([4, 8, 16]),
    extra=hs.integers(0, 8), adaptive=hs.booleans(),
    interval=hs.integers(1, 40))))
def test_streamed_equals_buffered_equals_oracle(oracle, p):
    ring = p["width"] + p["extra"]
    spec_kw = (dict(exec_policy=ExecPolicy(ladder=(max(p["width"] // 4, 1),
                                                    p["width"])))
               if p["adaptive"] else dict(exec_cap=p["width"]))
    scen = simulate.t0t1_scenario(*SCEN, **spec_kw)

    def drive(eng):
        return eng.run_adaptive() if p["adaptive"] else eng.run_local()

    buffered = drive(Engine(*scen, trace_cap=4096, device="cpu"))
    ts = mon.TraceStream()
    ms = mon.MetricsStream(p["interval"])
    st = drive(Engine(*scen, trace_cap=ring, device="cpu", trace_stream=ts,
                      metrics_stream=ms, drain_every=p["drain"]))
    assert int(st.trace_n.max()) > ring
    assert int(st.counters[:, mon.C_TRACE_DROP].sum()) == 0
    assert ts.merged() == merged_engine_trace(buffered.trace,
                                              buffered.trace_n) == oracle
    assert ts.n_streamed == len(oracle)
    assert ms.lines[-1]["counters"] == mon.snapshot(st.counters)
    windows = [r["window"] for r in ms.lines[:-1]]
    assert windows == list(range(p["interval"], int(st.windows[0]) + 1,
                                 p["interval"]))
    assert torch.equal(st.counters, buffered.counters)


T0T1 = ["t0t1", "--device", "cpu", "--agents", "4", "--bandwidths", "8.0",
        "--exec-cap", "16", "--stream-trace", "24"]


def test_cli_kill_and_resume(tmp_path, capsys):
    d = str(tmp_path / "ck")
    ck = ["--checkpoint-dir", d, "--checkpoint-every", "20"]
    whole = simulate.main(T0T1)
    assert len(whole) == 1 and "trace_drop=0" in whole[0]
    # the child keeps to one torch thread, as this process does
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    killed = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.simulate", *T0T1, *ck,
         "--kill-after-window", "40"],
        capture_output=True, text=True, env=env, timeout=300)
    assert killed.returncode == -signal.SIGKILL, killed.stderr
    assert "[t0t1]" not in killed.stdout
    assert sorted(os.listdir(d)) == ["step_000000020", "step_000000040"]
    capsys.readouterr()
    assert simulate.main([*T0T1, *ck, "--resume"]) == whole
    assert capsys.readouterr().out.splitlines() == [
        f"[resume] window 40 from {d}", whole[0]]
    # the options' own checks
    with pytest.raises(SystemExit, match="need --checkpoint-dir"):
        simulate.main([*T0T1, "--resume"])
    with pytest.raises(SystemExit, match="needs --checkpoint-every"):
        simulate.main([*T0T1, "--checkpoint-dir", d, "--kill-after-window",
                       "3"])
