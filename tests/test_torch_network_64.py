"""A 64-flow WAN region (the builder's default ``max_flow``), where the
reference's one-lane flow sum leaves left-to-right order: the probe of
``tests/test_torch_network.py`` at 64 flows, then the region through both
oracles and both one-agent engines. The two runs compile JAX engine code,
so they sit in a file of at most 3 tests (see test_torch_engine.py).
"""
import functools
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several worker processes on one machine: keep torch to one
# thread each, as the tensors here are small
torch.set_num_threads(1)

from repro.core import ScenarioBuilder  # noqa: E402
from repro.core import run_sequential as j_run_sequential  # noqa: E402
from repro.core.components import (DATA_WRITE, FLOW_START,  # noqa: E402
                                   JOB_SUBMIT)
from repro_torch.core import run_sequential  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

from test_torch_engine import (assert_states_equal, merged,  # noqa: E402
                               np_tree, port_scenario, run_both)
from test_torch_network import port_sum_tree, reference_sum_tree  # noqa: E402


def test_reference_one_lane_order_at_64_flows_is_the_ports():
    assert (reference_sum_tree(64) == port_sum_tree(64)).all()


def grid_64_flows():
    """A T0/T1 Grid whose WAN region holds 64 flows at once (the builder's
    default max_flow) over three links: five generators of 13 or 12
    transfers, one a tick, on routes [0], [0, 2], [1, 2], [1] and [2], so
    link 2 carries flows frozen at two levels. The run ends at tick 70,
    before any transfer finishes, so the world holds every rate."""
    b = ScenarioBuilder(max_cpu=4, queue_cap=64, max_link=4, max_flow=64)
    b.add_regional_center(n_cpu=4, cpu_power=10.0, disk=500.0, tape=5000.0,
                          tape_rate=5.0)
    t1 = b.add_regional_center(n_cpu=4, cpu_power=8.0, disk=3000.0,
                               tape=30000.0, tape_rate=5.0)
    wan = b.add_net_region(link_bws=[0.5, 0.7, 3.0], link_lats=[5, 5, 5])
    routes = [dict(l0=0), dict(l0=0, l1=2), dict(l0=1, l1=2), dict(l0=1),
              dict(l0=2)]
    for route, count in zip(routes, (13, 13, 13, 13, 12)):
        b.add_generator(
            target_lp=wan, kind=FLOW_START,
            payload=FLOW_START.pack(size=40.0, **route,
                                    notify_lp=t1["farm"],
                                    notify_kind=JOB_SUBMIT.id,
                                    notify2_lp=t1["storage"],
                                    notify2_kind=DATA_WRITE.id),
            interval=1, count=count, start=0)
    return b, dict(n_agents=1, lookahead=2, t_end=70, pool_cap=512,
                   work_per_mb=2.0)


@functools.lru_cache(maxsize=None)
def jax_oracle():
    """The reference's oracle on ``grid_64_flows``, run once a module."""
    b, kw = grid_64_flows()
    return j_run_sequential(*b.build(**kw))


def test_port_oracle_equals_jax_oracle_at_64_flows(monkeypatch):
    b, kw = grid_64_flows()
    scen = b.build(**kw)
    jw, jc, jtrace = jax_oracle()
    assert int(np.asarray(jw.flow_active).sum(1).max()) >= 56
    tw, tc, ttrace = run_sequential(*port_scenario(*scen))
    assert ttrace == jtrace
    assert_states_equal({k: v.numpy() for k, v in tw._asdict().items()},
                        np_tree(jw))
    assert_states_equal(tc.numpy(), np.asarray(jc))
    # the left-to-right sum of the batched context differs here
    monkeypatch.setattr(tref, "_UNBATCHED_ORDER", {})
    tw2, _, _ = run_sequential(*port_scenario(*scen))
    assert not np.array_equal(tw2.flow_rate.numpy().view(np.int32),
                              np.asarray(jw.flow_rate).view(np.int32))


def test_one_agent_engine_equals_jax_at_64_flows():
    """With one agent the reference's handler calls are unbatched in the
    conflict fallback (every flow event hits the one region), as in the
    oracle; the port's fallback has one lane there too."""
    b, kw = grid_64_flows()
    jstate, tstate, _, _ = run_both(b, kw, trace_cap=1024)
    assert jstate["counters"][0, 20] > 0            # C_BATCH_FALLBACK
    assert_states_equal(tstate, jstate)
    assert merged(tstate) == jax_oracle()[2]
