"""The port's engine with the reference insert (``insert_mode="ref"``: an
O(pool_cap) rank scan and a pool-wide reclaim mask) and the whole-table
merge (``merge_mode="dense"``), together and under the fused front end,
against JAX ``run_local`` and the oracle on the T0/T1 model with four
agents: same trace, counters, world, pool slot layout and ring cursors (see
test_torch_engine.py for why these files hold few tests).
"""
import pytest

torch = pytest.importorskip("torch")
# the suite runs several worker processes on one machine: keep torch to one
# thread each, as the tensors here are small
torch.set_num_threads(1)

from test_torch_engine import assert_run_matches, t0t1_run_both  # noqa: E402


@pytest.mark.parametrize("fused", [False, True])
def test_reference_insert_and_dense_merge(fused, t0t1_oracle):
    jstate, tstate, _, _ = t0t1_run_both(4, insert_mode="ref",
                                         merge_mode="dense",
                                         fused_select=fused)
    assert jstate["counters"][:, 0].sum() > 50
    assert_run_matches(jstate, tstate, t0t1_oracle[2])
