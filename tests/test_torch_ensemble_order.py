"""The max-min flow-sum order under the ensemble driver, against the
reference.

A one-agent engine's conflict fallback runs the flow handlers on one lane,
where XLA:CPU sums ``inc.T @ x`` in its unbatched order (64 flows here:
``kernels/ref.py::_UNBATCHED_ORDER``). The reference's replica vmap leaves
that order as it is, for one replica and for two: each replica sums as its
own ``run_local`` does. The port's ensemble runs R * A rows, so a handler
call holds R lanes per lane of one replica, and ``ops.lane_groups`` makes
``maxmin_rates`` take the order of one replica's lanes. Both runs equal the
reference's byte for byte; counting the R lanes as one call's would sum
left to right and differ.

Each JAX ensemble compiles for about 20 s, so this file holds two tests
(see test_torch_engine.py).
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several worker processes on one machine: keep torch to one
# thread each, as the tensors here are small
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.core import Engine as JEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import Engine  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

from test_torch_cache import jax_state  # noqa: E402
from test_torch_engine import assert_states_equal, port_scenario  # noqa: E402
from test_torch_network_64 import grid_64_flows  # noqa: E402


def ensembles(seeds):
    """(port ensemble, reference ensemble, port run_local, port scenario)
    of the 64-flow grid at one agent, as numpy."""
    b, kw = grid_64_flows()
    built = b.build(**kw)
    jout = JEngine(*built, trace_cap=1024).run_ensemble(seeds)
    jax.block_until_ready(jout.counters)
    want = jax_state(jout)
    scen = port_scenario(*built)
    got = convert.state_to_numpy(
        Engine(*scen, trace_cap=1024, device="cpu").run_ensemble(seeds))
    solo = convert.state_to_numpy(
        Engine(*scen, trace_cap=1024, device="cpu").run_local())
    assert int(want["world"]["flow_active"].sum(-1).max()) >= 56
    return got, want, solo, scen


def rate_bits(state):
    return state["world"]["flow_rate"].view(np.int32)


def test_one_replica_keeps_the_unbatched_order():
    got, want, solo, _ = ensembles([0])
    assert_states_equal(got, want, "R=1")
    np.testing.assert_array_equal(rate_bits(got)[0], rate_bits(solo))


def test_two_replicas_keep_the_unbatched_order(monkeypatch):
    got, want, solo, scen = ensembles([0, 1])
    assert_states_equal(got, want, "R=2")
    # no RNG field: both replicas are the one-agent run_local, whose
    # fallback sums 64 flows in the unbatched order
    for r in (0, 1):
        np.testing.assert_array_equal(rate_bits(got)[r], rate_bits(solo))
    # two lanes counted as one call's sum left to right, and differ here
    monkeypatch.setattr(tops, "lane_groups",
                        lambda n: contextlib.nullcontext())
    flat = convert.state_to_numpy(
        Engine(*scen, trace_cap=1024, device="cpu").run_ensemble([0, 1]))
    assert not np.array_equal(rate_bits(flat), rate_bits(want))
