"""The one-lane max-min flow sum at every tabled order, against the installed
XLA (see tests/test_torch_network.py for the probe and the reason).

``tools/probe_flow_order.py`` read the reference's tree at every F = 2-256
and L = 1-128 (F = 43-128 at L = 1-64 one pair a call, about 2.4
CPU-hours; the rest L pairs a call), and past it at every F = 257-512 at
L = 1-9, 64, 65, 128, 129 and 256, every F = 43-256 at L = 129, 130, 192,
255 and 256, and seeded samples of the other L up to 256; every tree there
has the ``FlowOrder`` form and is tabled in
``kernels/ref.py::_UNBATCHED_ORDER`` (F = 43-512, L = 1-256). Here, within
the test budget:

* the workload bridge's shapes (2n flows over n links) at n = 27, 40 and 45
  in full: every pair of the tree, and the max-min rates bit for bit;
  then (128, 128) and (256, 64), the same way;
* both ends of every tabled range of L up to F = 128 (those
  tests/test_torch_maxmin.py does not hold against the reference
  already), a seeded sample of 32 range ends at F = 129-256, a seeded
  sample of 8 of the ends at L = 256 at F = 129-256 (the table's last
  ranges, carried from L = 64 to 256), and a seeded sample of 8 range
  ends at F = 257-512: the port's tree checked at one pair of flows under
  each of its nodes (so every node's size is read off the reference),
  then the flow sums bit for bit on random inputs; the max-min rates bit
  for bit at a range end of each head form;
* shapes just past the table (F > 512 or L > 256), where the port sums
  left to right and the reference does not: the trees differ, and the
  rates' gap is measured and bounded.

The comparisons compile JAX code at each shape, so this file holds two
tests (see test_torch_cache.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several worker processes on one machine: keep torch to one
# thread each, as the tensors here are small
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.kernels import ref as tref  # noqa: E402

from test_torch_core import _one_lane_ulps  # noqa: E402
from test_torch_maxmin import TABLED  # noqa: E402
from test_torch_network import port_sum_tree, reference_sum_tree  # noqa: E402

M = 2.0**40


# the reference's one-lane flow sum, as reference_sum_tree compiles it (one
# program a shape)
DOT = jax.jit(lambda inc, r, fz: inc.T @ (r * fz.astype(jnp.float32)))


def reference_meet(F, L, pairs):
    """The reference's meet count of each pair of flows, read as
    ``reference_sum_tree`` reads it (M at flow i, -M at flow j, 1 elsewhere)
    but L pairs a compiled call, pair k in link column k."""
    r, fz = jnp.ones((F,), jnp.float32), jnp.ones((F,), bool)
    out = []
    for k in range(0, len(pairs), L):
        chunk = pairs[k:k + L]
        inc = np.ones((F, L), np.float32)
        for col, (i, j) in enumerate(chunk):
            inc[i, col], inc[j, col] = M, -M
        got = np.asarray(DOT(jnp.asarray(inc), r, fz))
        out += [F - int(got[col]) for col in range(len(chunk))]
    return out


def _tree(meet, leaves):
    """The binary tree with these pairwise meet counts, as nested pairs."""
    if len(leaves) == 1:
        return leaves[0]
    n, a = len(leaves), leaves[0]
    left = [a] + [j for j in leaves[1:] if meet[a, j] < n]
    right = [j for j in leaves if j not in set(left)]
    return (_tree(meet, left), _tree(meet, right))


def _leaves(t):
    return [t] if isinstance(t, int) else _leaves(t[0]) + _leaves(t[1])


def node_pairs(F, L, rng):
    """One pair of flows under each internal node of the port's tree, one
    on each side, and the node's leaf count."""
    pairs, sizes = [], []
    todo = [_tree(port_sum_tree(F, L), list(range(F)))]
    while todo:
        t = todo.pop()
        if isinstance(t, int):
            continue
        a, b = _leaves(t[0]), _leaves(t[1])
        pairs.append((rng.choice(a), rng.choice(b)))
        sizes.append(len(a) + len(b))
        todo += [t[0], t[1]]
    return pairs, sizes


def check_shape(F, L, seed):
    """The reference's one-lane flow sum at (F, L) is the port's: its tree
    at one pair under each node of the port's tree, then three random sums,
    all links, bit for bit."""
    rng = np.random.default_rng(seed)
    pairs, sizes = node_pairs(F, L, rng)
    assert reference_meet(F, L, pairs) == sizes, (F, L)
    fz = jnp.ones((F,), bool)
    for _ in range(3):
        inc = (rng.random((F, L)) < 0.7).astype(np.float32)
        x = (rng.random(F) * 2).astype(np.float32)
        want = np.asarray(DOT(jnp.asarray(inc), jnp.asarray(x), fz))
        contrib = (torch.from_numpy(inc) * torch.from_numpy(x)[:, None])
        got = tref._sum_flows(contrib[:, None, :].contiguous())[0].numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32), err_msg=(F, L))


def full_tree_equal(F, L) -> bool:
    """Every pair of the reference's tree against the port's."""
    port = port_sum_tree(F, L)
    pairs = [(i, j) for i in range(F) for j in range(i + 1, F)]
    return reference_meet(F, L, pairs) == [port[i, j] for i, j in pairs]


def test_bridge_shapes_and_the_untabled_gap():
    """The workload bridge's shapes of fault 1: the whole tree (at n = 27
    also as ``reference_sum_tree`` reads it, one pair a call on link 0),
    and the rates bit for bit; the same at 128 flows over 128 links and
    256 over 64. Then shapes past the table, F > 512 or L > 256: the
    reference sums in its tree there, the port left to right, and the
    rates differ in some lanes, by at most 16 ulps (513 flows over 16
    links, 12 lanes of 12) and 2 (256 over 257, 3 of 12); at 160 and 60
    flows over 257 links the trees differ (the rates of 12 lanes of 160
    flows happen to agree)."""
    assert (reference_sum_tree(54, 27) == port_sum_tree(54, 27)).all()
    for F, L in ((54, 27), (80, 40), (90, 45), (128, 128), (256, 64)):
        assert tref.flow_order(F, L, 1) != tref.LEFT_TO_RIGHT
        assert full_tree_equal(F, L)
        assert _one_lane_ulps(F, L, 12, L) == (0, 0)
    for F, L, lanes, ulps in ULPS_PAST:
        assert tref.flow_order(F, L, 1) == tref.LEFT_TO_RIGHT
        assert not full_tree_equal(F, L)
        if lanes:
            worst, differ = _one_lane_ulps(F, L, lanes, F)
            assert differ > 0 and worst <= ulps, (F, L)


# (F, L, lanes, largest gap in ulps as measured) past the table's edge
ULPS_PAST = ((513, 16, 12, 16), (256, 257, 12, 2), (160, 257, 0, 0),
             (60, 257, 0, 0))


def test_every_tabled_range_end_sums_as_the_reference():
    ends = sorted({(F, L) for F, ranges in tref._UNBATCHED_ORDER.items()
                   for lo, hi, _ in ranges for L in (lo, hi)})
    assert len(ends) > 2000
    low = [(F, L) for F, L in ends if F <= 128]
    assert len(low) > 280
    high = [e for e in ends if 128 < e[0] <= 256]
    pick = np.random.default_rng(26).choice(len(high), 32, replace=False)
    wide = [e for e in high if e[1] == 256]
    assert len(wide) == 128
    pick_wide = np.random.default_rng(27).choice(len(wide), 8, replace=False)
    past = [e for e in ends if e[0] > 256]
    pick_past = np.random.default_rng(28).choice(len(past), 8, replace=False)
    for F, L in (sorted(set(low) - set(TABLED)) + [high[i] for i in pick]
                 + [wide[i] for i in pick_wide]
                 + [past[i] for i in pick_past]):
        check_shape(F, L, F * 100 + L)
    # the rates, bit for bit, at a range end of each head form
    for F, L in ((43, 1), (53, 256), (60, 8), (80, 8), (127, 5), (128, 9),
                 (96, 256), (156, 5), (200, 1), (255, 256), (352, 1)):
        assert (F, L) in ends
        assert _one_lane_ulps(F, L, 4, F * 100 + L) == (0, 0), (F, L)
