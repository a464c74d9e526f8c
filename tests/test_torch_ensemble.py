"""The port's ensemble driver against the reference's, byte for byte.

``Engine.run_ensemble`` runs R seeded replicas as one fleet of R * A rows
and freezes each replica at its own end, as the reference's batched
``while_loop`` does. The failure/repair model (2 farms, pool_cap 128, seeds
0-5, whose replicas end at different windows) runs on the stitched and the
fused front end: every field of the (R, A, ...) result equals the
reference's ensemble, each replica equals the port's ``run_local`` of its
seeded state, and the ``MetricsStream.ensemble`` record equals the
reference's. The T0/T1 model at 2 agents (flows, routing between the
agents of a replica) has no RNG field, so its replicas are identical, and
equal to the reference's.

Each JAX ensemble compiles for about 20 s, so this file holds two tests and
queues behind the three-test files (see test_torch_engine.py).
"""
import dataclasses
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several worker processes on one machine: keep torch to one
# thread each, as the tensors here are small
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.core import Engine as JEngine  # noqa: E402
from repro.core import MetricsStream as JMetricsStream  # noqa: E402
from repro.scenarios import failures as jfail  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import Engine, MetricsStream  # noqa: E402
from repro_torch.core.engine import map_state, seed_rng_fields  # noqa: E402
from repro_torch.scenarios import failures as tfail  # noqa: E402

from conftest import t0t1_builder  # noqa: E402
from test_torch_engine import assert_states_equal, port_scenario  # noqa: E402
from test_torch_cache import jax_state  # noqa: E402


def replica(state: dict, r: int) -> dict:
    """Replica ``r``'s slice of a numpy (R, A, ...) state."""
    return {k: replica(v, r) if isinstance(v, dict) else v[r]
            for k, v in state.items()}


def test_failure_ensemble_equals_reference_and_run_local():
    seeds = np.arange(6, dtype=np.int32)
    jbuilt, _ = jfail.build_failure_scenario(n_farms=2, pool_cap=128)
    jms = JMetricsStream(interval=1_000_000, out=io.StringIO())
    jout = JEngine(*jbuilt, trace_cap=512, metrics_stream=jms).run_ensemble(
        seeds)
    jax.block_until_ready(jout.counters)
    want = jax_state(jout)
    windows = want["windows"][:, 0]
    assert len(set(windows.tolist())) > 1       # replicas end apart

    tbuilt, _ = tfail.build_failure_scenario(n_farms=2, pool_cap=128)
    for fused in (False, True):
        spec = dataclasses.replace(tbuilt[3], fused_select=fused)
        ms = MetricsStream(interval=1_000_000, out=io.StringIO())
        eng = Engine(*tbuilt[:3], spec, trace_cap=512, metrics_stream=ms,
                     device="cpu")
        out = eng.run_ensemble(seeds)
        got = convert.state_to_numpy(out)
        assert_states_equal(got, want, f"ensemble fused={fused}")
        # two host reads a window, as run_local makes, plus the last check
        assert eng.host_reads == 2 * int(windows.max()) + 1
        assert ms.out.getvalue() == jms.out.getvalue()
        assert json.loads(ms.out.getvalue()) == jms.latest
        for r in (0, 3, 5):
            assert ms.replica(r) == jms.replica(r)
        np.testing.assert_array_equal(ms.replica_counters,
                                      jms.replica_counters)
        np.testing.assert_array_equal(ms.replica_seeds, jms.replica_seeds)
        for r in range(len(seeds)):
            solo = Engine(*tbuilt[:3], spec, trace_cap=512, device="cpu")
            one = solo.run_local(state=seed_rng_fields(
                solo.init_state(), torch.tensor(seeds[r])))
            assert_states_equal(convert.state_to_numpy(one),
                                replica(got, r), f"replica {r} fused={fused}")
            assert_states_equal(
                convert.state_to_numpy(map_state(lambda x: x[r], out)),
                replica(got, r), f"map_state {r}")


def test_t0t1_two_agent_ensemble_replicas_equal_reference():
    b, kw = t0t1_builder()
    built = b.build(n_agents=2, **kw)
    seeds = [0, 1, 2]
    jout = JEngine(*built, trace_cap=256).run_ensemble(seeds)
    jax.block_until_ready(jout.counters)
    want = jax_state(jout)
    out = Engine(*port_scenario(*built), trace_cap=256,
                 device="cpu").run_ensemble(seeds)
    got = convert.state_to_numpy(out)
    assert_states_equal(got, want, "t0t1 ensemble")
    for r in (1, 2):
        assert_states_equal(replica(got, r), replica(got, 0), f"replica {r}")
    assert got["counters"][0].sum(0)[0] > 0
    assert got["done"].all()
