"""The scheduler's float32 sums over agents against the reference's, bit
for bit, beyond 32 agents.

XLA:CPU sums a row of A values in chunks from 33 agents on
(``repro_torch.core.scheduler.sum_chunks``, read by
``tools/probe_sum_order.py`` at every A = 33-512). The probe's own reading
of the reference's tree equals the rule at both ends of each form (two,
three and four chunks, and at 129 and 512); ``_sum_last``, the row sums
and scores of ``placement_scores`` and ``rebalance``'s mean equal
``jnp.sum``, ``jnp.mean`` and the reference's functions bit for bit there,
at 48 and 100 agents and at 129, 160, 256 and 512, on values of mixed
magnitudes whose sums depend on the order. Beyond 512 agents the port sums
left to right, and the gap to the reference stays within a bound.

The reference's functions compile once per shape (a few seconds in all),
so this file holds two tests (see test_torch_engine.py).
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import scheduler as jsch  # noqa: E402
from repro_torch.core import monitoring as tmon  # noqa: E402
from repro_torch.core import scheduler as tsch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import probe_sum_order  # noqa: E402

# both ends of each form, and the agent counts named in ROADMAP.md
FORM_ENDS = (32, 33, 64, 65, 96, 97, 128)
SHAPES = FORM_ENDS + (48, 100)


def mixed(rng, shape):
    """float32 values over six decades, so the sums round differently in
    another order."""
    return (rng.uniform(0, 1000, shape)
            * 10.0 ** rng.integers(-3, 3, shape)).astype(np.float32)


def bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def ulps(a, b):
    """The distance in float32 steps between positive values."""
    return np.abs(bits(a).astype(np.int64) - bits(b).astype(np.int64))


def t_(x):
    return torch.from_numpy(np.asarray(x))


def test_sums_scores_and_mean_equal_reference_bit_for_bit():
    assert [tsch.sum_chunks(A) for A in (32, 33, 64, 65, 100, 128)] == [
        [32], [17, 16], [32, 32], [17, 32, 16], [18, 32, 32, 18],
        [32, 32, 32, 32]]
    for A in (33, 64, 65, 97, 128):
        got = probe_sum_order.probe_rows(A)
        assert probe_sum_order.chunks_of(got) == tsch.sum_chunks(A), A
    rng = np.random.default_rng(0)
    for A in SHAPES:
        x = mixed(rng, (A,))
        np.testing.assert_array_equal(bits(tsch._sum_last(t_(x))),
                                      bits(jnp.sum(jnp.asarray(x))))
        d = mixed(rng, (A, A))
        perf = mixed(rng, (A,))
        np.testing.assert_array_equal(
            bits(tsch._sum_last(t_(d))), bits(jnp.sum(jnp.asarray(d), 1)))
        for part in (np.ones(A, bool), rng.integers(0, 2, A) > 0):
            np.testing.assert_array_equal(
                bits(tsch.placement_scores(t_(d), t_(part), t_(perf))),
                bits(jsch.placement_scores(jnp.asarray(d), jnp.asarray(part),
                                           jnp.asarray(perf))),
                err_msg=f"scores A={A}")
        # rebalance's mean: the sum times the float32 reciprocal
        mean = tsch._sum_last(t_(perf)) * float(np.float32(1) / np.float32(A))
        np.testing.assert_array_equal(bits(mean),
                                      bits(jnp.mean(jnp.asarray(perf))))
    # whole placements where the sums decide, at one end of two forms
    for A in (33, 100):
        c = rng.integers(0, 5000, (A, tmon.N_COUNTERS)).astype(np.int32)
        la = rng.integers(0, A, 40).astype(np.int32)
        ctx = rng.integers(0, 3, 40).astype(np.int32)
        occ = rng.integers(0, 100, A).astype(np.int32)
        for thr in (1.05, 2.0):
            np.testing.assert_array_equal(
                tsch.rebalance(t_(c), t_(la), t_(ctx), t_(occ),
                               threshold=thr).numpy(),
                np.asarray(jsch.rebalance(
                    jnp.asarray(c), jnp.asarray(la), jnp.asarray(ctx),
                    jnp.asarray(occ), threshold=thr)))


def test_unprobed_agent_counts_gap_is_bounded():
    """From 129 to 512 agents, once unprobed (the port summed left to right
    there), the probe read the same chunk rule at every count: the port
    equals the reference bit for bit at 129, 160, 256 and 512 agents (the
    probe's tree at 129 and 512; ``_sum_last`` against ``jnp.sum`` of a
    vector and of an (A, A) matrix's rows, ``placement_scores``, and
    ``rebalance``'s mean). Beyond 512 the port sums left to right; on
    values of mixed magnitudes it stays within 16 float32 steps of the
    reference, and differs somewhere (the order is not the reference's
    there)."""
    assert tsch.PROBED_AGENTS == 512
    assert tsch.sum_chunks(512) == [32] * 16
    for A in (129, 512):
        got = probe_sum_order.probe_rows(A)
        assert probe_sum_order.chunks_of(got) == tsch.sum_chunks(A), A
    rng = np.random.default_rng(1)
    for A in (129, 160, 256, 512):
        assert len(tsch.sum_chunks(A)) == -(-A // 32)
        x = mixed(rng, (A,))
        np.testing.assert_array_equal(bits(tsch._sum_last(t_(x))),
                                      bits(jnp.sum(jnp.asarray(x))))
        d = mixed(rng, (A, A))
        perf = mixed(rng, (A,))
        np.testing.assert_array_equal(
            bits(tsch._sum_last(t_(d))), bits(jnp.sum(jnp.asarray(d), 1)))
        part = rng.integers(0, 2, A) > 0
        np.testing.assert_array_equal(
            bits(tsch.placement_scores(t_(d), t_(part), t_(perf))),
            bits(jsch.placement_scores(jnp.asarray(d), jnp.asarray(part),
                                       jnp.asarray(perf))),
            err_msg=f"scores A={A}")
        mean = tsch._sum_last(t_(perf)) * float(np.float32(1) / np.float32(A))
        np.testing.assert_array_equal(bits(mean),
                                      bits(jnp.mean(jnp.asarray(perf))))
    worst, differ = 0, 0
    for A in (513, 640):
        assert tsch.sum_chunks(A) == [A]
        d = mixed(rng, (64, A))
        got = tsch._sum_last(t_(d)).numpy()
        want = np.asarray(jax.jit(lambda x: jnp.sum(x, 1))(jnp.asarray(d)))
        gap = ulps(got, want)
        worst, differ = max(worst, int(gap.max())), differ + int(
            (gap > 0).sum())
    assert differ > 0
    assert worst <= 16, worst
