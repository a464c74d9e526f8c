"""Two comparisons whose reference runs eagerly, so each takes seconds:
the port's plain ``fused_select`` against the JAX Pallas megakernel in
interpret mode (``tests/test_torch_kernels.py`` holds it against the
reference's XLA twins), and the reference insert and reclaim
(``insert_ref``, ``pop_mask_ref``) against the JAX package's, op by op
(``tests/test_torch_core.py`` holds the rest of the event pool). They sit
in a file of at most 3 tests, which xdist's ``loadfile`` hands out after
the long reference files (see test_torch_engine.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several worker processes on one machine: keep torch to one
# thread each, as the tensors here are small
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import events as jev  # noqa: E402
from repro.kernels import event_select as jes  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

from test_torch_core import (_random_pools, assert_pools_same,  # noqa: E402
                             j_agent, rand_batch, t_batch)
from test_torch_kernels import (FUSED_KW, TWIN_KW,  # noqa: E402
                                _assert_counts, _assert_fused_equal,
                                _fused_inputs)


def test_fused_select_matches_pallas():
    """One small case against the Pallas megakernel in interpret mode."""
    inp = _fused_inputs(30, 0.6, 25, 9)
    got, counts = ref.fused_select(
        *(torch.from_numpy(v) for v in inp.values()), 12, **FUSED_KW)
    want = jes.fused_select(*(jnp.asarray(v[1]) for v in inp.values()), 12,
                            **TWIN_KW, interpret=True)
    _assert_fused_equal(got, want, 1)
    _assert_counts(counts[1], want)


def test_reference_insert_and_reclaim_match_reference():
    """insert_ref (ascending free slots, overflow counted) and pop_mask_ref,
    twice over, on pools whose ring is not the identity."""
    rng = np.random.default_rng(21)
    A, cap = 3, 16
    pool_t, pools_j = _random_pools(rng, A, cap, 10)
    for step, p_valid in enumerate((0.9, 0.6)):
        b = rand_batch(rng, A, 12, p_valid)
        pool_t, drop_t = tev.insert_ref(pool_t, t_batch(b))
        mask = rng.random((A, cap)) < 0.4
        pool_t = tev.pop_mask_ref(pool_t, torch.from_numpy(mask))
        for a in range(A):
            pools_j[a], drop_j = jev.insert_ref(pools_j[a], j_agent(b, a))
            assert int(drop_j) == int(drop_t[a])
            pools_j[a] = jev.pop_mask_ref(pools_j[a], jnp.asarray(mask[a]))
        assert_pools_same(pool_t, pools_j, str(step))
