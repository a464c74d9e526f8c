"""The port's max-min water-fill against the reference, bit for bit.

The plain ``repro_torch.kernels.ref.maxmin_rates`` is what CPU tensors take
and what chip_smoke.py holds the CUDA kernel (``csrc/bandwidth_share.cu``)
against on the card. Here it is held against JAX ``core.network.
maxmin_rates`` in both of the reference's contexts: vmapped over lanes
(``jax.jit(jax.vmap(...))``, summing flows left to right) and on one lane
(``jax.jit(...)``, the order of ``ref.flow_order``), and against the Pallas
kernel ``maxmin_rates_pallas`` in interpret mode. That kernel's sums come out
in the batched order: it equals the port's batched form bit for bit on
these inputs (a stricter bar than tests/test_kernels.py's 1e-5), and
differs from the one-lane form by a few ulps where the one-lane order is not
left to right. Shapes are the workload bridge's (``2 * n_pods`` flow slots
over ``n_pods`` links for 2, 25, 32, 48 and 64 pods) and tiered_grid's
(32 flows, 4 links), and every tabled one-lane order at both ends of its
range of link counts; each shape compiles its own JAX programs, shared by
all of its lanes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several worker processes on one machine: keep torch to one
# thread each, as the tensors here are small
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import network as jnet  # noqa: E402
from repro.kernels.bandwidth_share import maxmin_rates_pallas  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.kernels import bandwidth_share as bs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

SWEEP_BW = (8.0, 2.0, 0.5, 0.125, 0.2, 0.0, 1.3)
_ONE_LANE = jax.jit(jnet.maxmin_rates)
_PALLAS = jax.jit(lambda inc, bw, act: maxmin_rates_pallas(
    inc, bw, act, interpret=True))


def bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def flows(B, F, L, seed):
    """Seeded (links, bw, active) for B lanes: random one- to three-hop
    routes, bandwidths from the t0t1 sweep (with 0.0), and four edge lanes:
    no active flow, every link's bandwidth 0, one active flow, and routes
    that repeat a hop."""
    rng = np.random.default_rng(seed)
    links = rng.integers(-1, L, (B, F, 3)).astype(np.int32)
    links[:, :, 0] = rng.integers(0, L, (B, F))
    bw = rng.choice(SWEEP_BW, (B, L)).astype(np.float32)
    active = rng.random((B, F)) < 0.7
    active[0] = False
    bw[1] = 0.0
    active[2] = False
    active[2, F // 2] = True
    links[3, :, 1] = links[3, :, 0]
    return links, bw, active


def port_inputs(links, bw, active, L):
    return (tnet.incidence(torch.from_numpy(links), L), torch.from_numpy(bw),
            torch.from_numpy(active))


@pytest.mark.parametrize("F,L", [(16, 2), (50, 25), (64, 32), (96, 48),
                                 (128, 64), (32, 4)])
def test_maxmin_rates_equal_reference_at_workload_shapes(F, L):
    B = 16
    links, bw, active = flows(B, F, L, F * 1000 + L)
    inc_t, bw_t, act_t = port_inputs(links, bw, active, L)
    inc_j = jax.vmap(lambda x: jnet.incidence(x, L))(jnp.asarray(links))
    np.testing.assert_array_equal(inc_t.numpy(), np.asarray(inc_j))

    # batched: B lanes, left to right
    got = ref.maxmin_rates(inc_t, bw_t, act_t)
    want = jax.jit(jax.vmap(jnet.maxmin_rates))(inc_j, jnp.asarray(bw),
                                                jnp.asarray(active))
    np.testing.assert_array_equal(bits(got), bits(want))
    assert (got[0] == 0).all() and (got[1] == 0).all()
    assert int((got[2] > 0).sum()) <= 1
    # the dispatcher sends CPU tensors to the plain version
    bs.reset_launches()
    np.testing.assert_array_equal(bits(ops.maxmin_rates(inc_t, bw_t, act_t)),
                                  bits(got))
    np.testing.assert_array_equal(bits(tnet.maxmin_rates(inc_t, bw_t,
                                                         act_t)), bits(got))
    assert bs.LAUNCHES["maxmin_rates"] == 0

    # one lane: the reference's unbatched order (left to right at F = 16
    # and 32, a tabled order at the others)
    for b in (0, 1, 2, 3, 4, 5):
        one = ref.maxmin_rates(inc_t[b:b + 1], bw_t[b:b + 1], act_t[b:b + 1])
        np.testing.assert_array_equal(
            bits(one[0]), bits(_ONE_LANE(inc_j[b], bw[b], active[b])),
            err_msg=f"lane {b}")

    # the Pallas kernel (interpret mode) equals the batched form
    for b in (3, 4):
        np.testing.assert_array_equal(
            bits(_PALLAS(inc_j[b], bw[b], active[b])), bits(got[b]),
            err_msg=f"lane {b}")


# A fixed sample of tabled shapes, each at an end of a range of link
# counts, up to the workload's widest (64 links); tests/test_torch_flow_order.py
# checks both ends of every range.
TABLED = [(44, 1), (48, 1), (49, 1), (50, 1), (50, 3), (50, 64), (51, 1),
          (51, 3), (51, 64), (52, 1), (52, 3), (52, 8), (52, 9), (52, 64),
          (56, 1), (56, 3), (56, 8), (56, 9), (56, 64), (58, 29), (60, 1),
          (60, 9), (60, 64), (62, 31), (64, 1), (64, 2), (64, 8), (64, 9),
          (64, 64), (65, 1), (65, 64), (66, 1), (66, 64), (67, 1), (67, 64),
          (68, 1), (68, 2), (68, 8), (68, 9), (68, 64), (70, 35), (72, 1),
          (72, 2), (72, 8), (72, 9), (72, 64), (74, 37), (76, 1), (76, 9),
          (76, 64), (78, 39), (80, 1), (82, 41), (84, 42), (86, 43),
          (88, 44), (92, 46), (94, 47), (96, 1), (96, 2), (96, 8), (96, 9),
          (96, 64), (98, 49), (100, 50), (102, 51), (104, 52), (106, 53),
          (108, 54), (110, 55), (112, 56), (114, 57), (116, 58), (118, 59),
          (120, 60), (122, 61), (124, 62), (126, 63), (128, 1), (128, 2),
          (128, 8), (128, 9), (128, 64)]


@pytest.mark.parametrize("F,L", TABLED)
def test_one_lane_order_at_tabled_link_counts(F, L):
    """Tabled one-lane orders at ends of their ranges of link counts."""
    assert ref.flow_order(F, L, 1) != ref.LEFT_TO_RIGHT
    links, bw, active = flows(6, F, L, F * 100 + L)
    inc_t, bw_t, act_t = port_inputs(links, bw, active, L)
    inc_j = np.asarray(inc_t)
    for b in range(6):
        got = ref.maxmin_rates(inc_t[b:b + 1], bw_t[b:b + 1], act_t[b:b + 1])
        np.testing.assert_array_equal(
            bits(got[0]), bits(_ONE_LANE(inc_j[b], bw[b], active[b])),
            err_msg=f"lane {b}")


def test_flow_order_is_the_kernels_contract():
    """One lane at a tabled (F, L) takes its tabled order, every other case
    left to right; each order is one the kernel takes: a permutation of the
    head's 8-flow blocks (up to 64, packed a byte a block in eight 64-bit
    words), runs that divide it, and a tail that divides into its
    interleaved sums. The table covers F = 43-512 at L = 1-256."""
    assert ref.flow_order(128, 4, 1) == ref._ORDER_96
    assert ref.flow_order(128, 1, 1) == ref._ORDER_128
    assert ref.flow_order(128, 64, 1) == ref._ORDER_128_CHAINS
    assert ref.flow_order(128, 4, 2) == ref.LEFT_TO_RIGHT
    assert ref.flow_order(60, 8, 1) == ref._ORDER_48._replace(
        tail_lanes=4, trailing=4)
    assert ref.flow_order(60, 65, 1) == ref._ORDER_48._replace(
        tail_lanes=4)
    assert ref.flow_order(60, 256, 1) == ref._ORDER_48._replace(
        tail_lanes=4)
    assert ref.flow_order(60, 257, 1) == ref.LEFT_TO_RIGHT
    assert ref.flow_order(128, 256, 1) == ref._ORDER_128_CHAINS
    assert ref.flow_order(256, 1, 1) == ref._head(256)
    assert ref.flow_order(256, 64, 1) == ref._head(256, chains=4)
    assert ref.flow_order(256, 256, 1) == ref._head(256, chains=4)
    # past 256 flows: one chain up to L = 8 while the head is at most
    # _ONE_CHAIN_HEAD[L] flows, four above
    assert ref.flow_order(257, 4, 1) == ref._head(256)
    assert ref.flow_order(320, 1, 1) == ref._head(320)
    assert ref.flow_order(352, 1, 1) == ref._head(352, chains=4)
    assert ref.flow_order(352, 2, 1) == ref._head(320)
    assert ref.flow_order(384, 3, 1) == ref._head(352)
    assert ref.flow_order(385, 3, 1) == ref._head(384, chains=4)
    assert ref.flow_order(480, 2, 1) == ref._head(448)
    assert ref.flow_order(481, 2, 1) == ref._head(480, chains=4)
    assert ref.flow_order(512, 1, 1) == ref._head(512, chains=4)
    assert ref.flow_order(512, 256, 1) == ref._head(512, chains=4)
    assert ref.flow_order(512, 257, 1) == ref.LEFT_TO_RIGHT
    assert ref.flow_order(513, 4, 1) == ref.LEFT_TO_RIGHT
    assert ref.flow_order(42, 7, 1) == ref.LEFT_TO_RIGHT
    assert ref.flow_order(42, 256, 1) == ref.LEFT_TO_RIGHT
    assert sorted(ref._UNBATCHED_ORDER) == list(range(43, 513))
    for F, ranges in ref._UNBATCHED_ORDER.items():
        assert ranges[-1][1] == (1 if F < 50 else 256), F
        for lo, hi, order in ranges:
            assert 1 <= lo <= hi <= 256
            assert order.head <= 512
            words = bs._pack_order(order, F, 64)
            assert len(words) == 8
            assert [(words[k // 8] >> (8 * (k % 8))) & 255
                    for k in range(order.head // 8)] == list(order.blocks)
    with pytest.raises(ValueError, match="flow order"):
        bs._pack_order(ref._head(512, chains=4), 512, 32)
    for bad in (ref.FlowOrder(48, (0, 1, 2, 3, 4, 4)),
                ref.FlowOrder(48, (0, 1, 2, 3, 4, 5), chains=4),
                ref.FlowOrder(48, (0, 1, 2, 3, 4, 5), tail_lanes=4),
                ref.FlowOrder(0, (), tail_lanes=2)):
        with pytest.raises(ValueError, match="flow order"):
            bs._pack_order(bad, 50, 64)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches its kernel or raises: a CPU tensor's result is
    the dispatcher's plain path, never the wrapper's."""
    inc = torch.zeros((2, 4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        bs.maxmin_rates(inc, torch.ones((2, 3)),
                        torch.ones((2, 4), dtype=torch.bool))
