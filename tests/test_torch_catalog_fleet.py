"""The port's scenario catalog, ``simulate run`` and fleet orchestrator
against the reference's.

Every catalog entry builds, at its defaults, the world, ownership, initial
events and spec the reference's entry builds. ``simulate run --list``
prints the reference's listing, and ``simulate run t0t1`` and ``simulate
run ensemble_farm`` its ``[run]`` lines; the errors are the reference's
``SystemExit`` texts. Then the checkpoints cross packages: a JAX
orchestrator run with no retry left is stopped by its injected probe after
a committed checkpoint, leaving an unclean ``fleet.json``; the port's
orchestrator books the preemption, resumes from the reference's
checkpoint, and ends equal to the run that never stopped.

The reference's runs compile JAX engine code (about 40 s in all), so this
file holds two tests (see test_torch_engine.py).
"""
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.fleet import FleetError as JFleetError  # noqa: E402
from repro.fleet import FleetPolicy as JFleetPolicy  # noqa: E402
from repro.fleet import Orchestrator as JOrchestrator  # noqa: E402
from repro.launch import simulate as jsimulate  # noqa: E402
from repro.scenarios import catalog as jcatalog  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import Engine  # noqa: E402
from repro_torch.fleet import FleetPolicy, Orchestrator  # noqa: E402
from repro_torch.launch import simulate  # noqa: E402
from repro_torch.scenarios import catalog  # noqa: E402

from test_torch_cache import assert_builds_equal  # noqa: E402
from test_torch_engine import assert_states_equal  # noqa: E402

ERRORS = (["run", "nope"], ["run", "t0t1", "--set", "bogus=1"],
          ["run", "t0t1", "--set", "novalue"], ["run"],
          ["run", "t0t1", "--preempt-at-window", "4"],
          ["run", "t0t1", "--stream-check"])


def reference_lines(argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["simulate", *argv])
    jsimulate.main()
    return [ln for ln in capsys.readouterr().out.splitlines()
            if not ln.startswith("{")]


def test_catalog_builds_and_cli_lines_equal_reference(capsys, monkeypatch):
    assert catalog.names() == jcatalog.names()
    for name in catalog.names():
        tsd, jsd = catalog.get(name), jcatalog.get(name)
        assert (tsd.params, tsd.driver, tsd.doc) == (jsd.params, jsd.driver,
                                                     jsd.doc)
        tbuilt, tparams = catalog.resolve(name)
        jbuilt, jparams = jcatalog.resolve(name)
        assert tparams == jparams
        assert_builds_equal(tbuilt, jbuilt)
    over = {"wan_bw": "0.5", "n_flows": "5", "fused": "yes"}
    assert_builds_equal(catalog.resolve("t0t1", over)[0],
                        jcatalog.resolve("t0t1", over)[0])
    for argv in ERRORS:
        with pytest.raises(SystemExit) as want:
            reference_lines(argv, capsys, monkeypatch)
        with pytest.raises(SystemExit) as got:
            simulate.main([*argv, "--device", "cpu"])
        assert str(got.value) == str(want.value), argv
    for argv in (["run", "--list"], ["run", "t0t1"],
                 ["run", "ensemble_farm"]):
        want = reference_lines(argv, capsys, monkeypatch)
        got = simulate.main([*argv, "--device", "cpu"])
        assert capsys.readouterr().out.splitlines() == got == want, argv


def test_port_resumes_a_reference_run_stopped_after_a_checkpoint(tmp_path):
    built_kw = {"n_flows": "8", "n_agents": "2", "exec_cap": "8"}
    jbuilt = jcatalog.resolve("t0t1", built_kw)[0]
    tbuilt = catalog.resolve("t0t1", built_kw)[0]
    whole = Engine(*tbuilt, device="cpu").run_local()
    jpol = JFleetPolicy(checkpoint_dir=str(tmp_path), checkpoint_every=8,
                        max_retries=0)
    with pytest.raises(JFleetError, match="retry cap"):
        JOrchestrator(jpol, preempt=lambda w, a: 1 if w >= 20 else None).run(
            jbuilt)
    with open(tmp_path / "fleet.json") as f:
        side = json.load(f)
    assert side["clean"] is False and side["n_devices"] == 1
    pol = FleetPolicy(checkpoint_dir=str(tmp_path), checkpoint_every=8)
    res = Orchestrator(pol).run(tbuilt, devices=[torch.device("cpu")])
    assert res.attempts == 1
    assert res.counts == {"PREEMPT": 1, "RESUME": 1, "RESHARD": 0}
    assert_states_equal(convert.state_to_numpy(res.state),
                        convert.state_to_numpy(whole), "resumed")
    assert int(np.asarray(res.state.windows)[0]) > 20
    with open(tmp_path / "fleet.json") as f:
        assert json.load(f)["clean"] is True
