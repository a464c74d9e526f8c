"""The port's engine through the sequential fold (``batched_dispatch=False``)
against JAX ``run_local``, and the port's sequential oracle against the JAX
oracle, on the T0/T1 model with one agent (see test_torch_engine.py for why
these files hold few tests).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several worker processes on one machine: keep torch to one
# thread each, as the tensors here are small
torch.set_num_threads(1)

from repro_torch.core import run_sequential  # noqa: E402

from conftest import t0t1_builder  # noqa: E402
from test_torch_engine import (assert_run_matches,  # noqa: E402
                               assert_states_equal, np_tree, port_scenario,
                               t0t1_run_both)


def test_t0t1_sequential_fold_equals_jax_run_local(t0t1_oracle):
    jstate, tstate, _, _ = t0t1_run_both(batched_dispatch=False)
    assert_run_matches(jstate, tstate, t0t1_oracle[2])


def test_port_oracle_equals_jax_oracle(t0t1_oracle):
    """run_sequential on the port's handlers: same trace, world and
    counters as the JAX oracle."""
    b, kw = t0t1_builder()
    scen = b.build(n_agents=1, **kw)
    jw, jc, jtrace = t0t1_oracle
    tw, tc, ttrace = run_sequential(*port_scenario(*scen))
    assert ttrace == jtrace
    assert_states_equal({k: v.numpy() for k, v in tw._asdict().items()},
                        np_tree(jw))
    assert_states_equal(tc.numpy(), np.asarray(jc))
