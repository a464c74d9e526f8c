"""The port's engine with the fused window front end
(``spec.fused_select=True``) against JAX ``run_local`` and the oracle, on the
T0/T1 model: one agent, four agents (emits routed across agents, inserts
through ``ring_slots``) and the sequential fold. The port runs its default
hooks, the plain ``fused_select`` and ``ring_slots``, and in the sequential
fold its stitched twin ``fused_select_xla`` as the ``fused_fn``; the JAX
engine runs ``fused_select_xla`` (see test_torch_engine.py for why these
files hold few tests).
"""
import pytest

torch = pytest.importorskip("torch")
# the suite runs several worker processes on one machine: keep torch to one
# thread each, as the tensors here are small
torch.set_num_threads(1)

from test_torch_engine import assert_run_matches, t0t1_run_both  # noqa: E402


@pytest.mark.parametrize("n_agents", [1, 4])
def test_fused_front_end_equals_jax_run_local_and_oracle(n_agents,
                                                         t0t1_oracle):
    jstate, tstate, _, _ = t0t1_run_both(n_agents, fused_select=True)
    assert jstate["counters"][:, 0].sum() > 50
    if n_agents > 1:
        assert jstate["counters"][:, 1].sum() > 0   # C_MSGS_REMOTE
    assert_run_matches(jstate, tstate, t0t1_oracle[2])


def test_fused_front_end_sequential_fold(t0t1_oracle):
    jstate, tstate, _, _ = t0t1_run_both(fused_select=True,
                                         batched_dispatch=False,
                                         port_twin=True)
    assert_run_matches(jstate, tstate, t0t1_oracle[2])
