"""The port's engine on multi-agent models, against JAX ``run_local`` and
the JAX oracle: the quickstart model (examples/quickstart.py) with 4 agents,
and a two-Tier-1 cut of chip_smoke.py's tiered Grid with 4 agents and
pool_cap 256 (its transfer counts cut to 8 and 4 per generator to keep the
test short). Emits that cross agents go through the agent-dimension
transpose; the tiered Grid also drives the conflict fallback. (See
test_torch_engine.py for why these files hold few tests.)
"""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several worker processes on one machine: keep torch to one
# thread each, as the tensors here are small
torch.set_num_threads(1)

from repro.core import components as jcomp  # noqa: E402
from repro.core import run_sequential as j_run_sequential  # noqa: E402
from repro_torch.core import run_sequential  # noqa: E402

from test_torch_core import quickstart_model  # noqa: E402
from test_torch_engine import (assert_states_equal, merged,  # noqa: E402
                               port_scenario, run_both)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _model(name):
    """The builder and build arguments; exec_cap 32 holds every window of
    these runs (no spill) at an eighth of the default lanes."""
    if name == "quickstart":
        return quickstart_model(jcomp), dict(
            n_agents=4, lookahead=2, t_end=20_000, pool_cap=512,
            work_per_mb=2.0, exec_cap=32)
    cs = _chip_smoke()
    return (cs.tiered_grid(jcomp, n_t1=2, t1_count=8, t2_count=4),
            dict(cs.tiered_build_kw(n_agents=4, pool_cap=256), exec_cap=32))


@pytest.mark.parametrize("name", ["quickstart", "tiered_grid"])
def test_equals_jax_run_local_and_oracles(name):
    """Byte-equal states; the port's merged trace, the port's oracle and the
    JAX oracle hold the same events. The tiered Grid's generators make
    colliding seq ids, so events of different LPs may share (time, seq);
    their relative order is arbitrary and its traces are compared in
    full-row order."""
    builder, kw = _model(name)
    jstate, tstate, scen, tscen = run_both(builder, kw, trace_cap=1024)
    c = jstate["counters"].sum(0)
    assert c[1] > 0, "no emit crossed agents"      # C_MSGS_REMOTE
    assert c[9:13].sum() == 0                       # no drops
    assert c[18] == 0                               # no spill
    if name == "tiered_grid":
        assert c[20] > 0, "no conflict fallback"    # C_BATCH_FALLBACK
    assert_states_equal(tstate, jstate)
    _w, _c, jtrace = j_run_sequential(*scen)
    _w, _c, ttrace = run_sequential(*tscen)
    assert ttrace == jtrace
    assert sorted(merged(tstate)) == sorted(jtrace)
    if name == "quickstart":
        assert merged(tstate) == jtrace


def test_builders_make_the_same_tiered_grid():
    from repro_torch.core import components as tcomp
    cs = _chip_smoke()
    kw = cs.tiered_build_kw(n_agents=4, pool_cap=256)
    tw, to, te, ts = cs.tiered_grid(tcomp, n_t1=2).build(**kw)
    jw, jo, je, js = cs.tiered_grid(jcomp, n_t1=2).build(**kw)
    for t, j in ((tw, jw), (to, jo), (te, je)):
        for f, v in j._asdict().items():
            assert_states_equal(getattr(t, f).numpy(), np.asarray(v), f)
    assert ts == port_scenario(jw, jo, je, js)[3]
