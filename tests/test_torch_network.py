"""The max-min flow sum in the reference's one-lane context.

XLA:CPU sums ``inc.T @ (rate * frozen)`` left to right when the handler is
batched over several lanes, but on one lane (the oracle's single-event
step; the engine with one agent, whose vmap of size 1 XLA removes) it
compiles a vectorised matvec whose summation order depends on the flow
count. The port reproduces the orders listed in
``repro_torch.kernels.ref._UNBATCHED_ORDER``. Here: the probe that reads
that order off the reference, held against the port's order at the flow
and link counts where the tree takes its other forms.
``tests/test_torch_network_64.py`` runs the probe at 64 flows and a 64-flow
region through both oracles and both one-agent engines (see
test_torch_engine.py for why these files hold few tests).
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


def reference_sum_tree(F, L=4):
    """The reference's one-lane flow sum as a tree, read off its compiled
    matvec: with x = 1 everywhere except M at flow i and -M at flow j
    (M = 2**40 absorbs every 1 it meets), the result is F minus the number
    of leaves under the node where i and j first meet. Returns that count
    for every pair."""
    dot = jax.jit(lambda inc, r, fz: inc.T @ (r * fz.astype(jnp.float32)))
    inc = jnp.ones((F, L), jnp.float32)
    fz = jnp.ones((F,), bool)
    meet = np.zeros((F, F), np.int64)
    for i in range(F):
        for j in range(i + 1, F):
            x = np.ones(F, np.float32)
            x[i], x[j] = 2.0**40, -2.0**40
            meet[i, j] = meet[j, i] = F - int(dot(inc, jnp.asarray(x), fz)[0])
    return meet


def port_sum_tree(F, L=4):
    """The same counts for the port's one-lane order (``_sum_flows``) over L
    links, run on symbolic leaves: a partial sum is the set of flows under
    it."""
    meet = np.zeros((F, F), np.int64)

    class Sum:
        def __init__(self, flows):
            self.flows = flows

        def __add__(self, other):
            for i in self.flows:
                for j in other.flows:
                    meet[i, j] = meet[j, i] = (len(self.flows)
                                               + len(other.flows))
            return Sum(self.flows | other.flows)

    class Rows:
        """Stands in for the (F, B, L) tensor: a list along dim 0."""

        def __init__(self, xs):
            self.xs = xs
            self.shape = (len(xs), 1, L)

        def __getitem__(self, k):
            return Rows(self.xs[k]) if isinstance(k, slice) else self.xs[k]

        def reshape(self, shape):
            n = shape[1]
            return Rows([Rows(self.xs[b * n:(b + 1) * n])
                         for b in range(shape[0])])

        def __add__(self, other):
            return Rows([a + b for a, b in zip(self.xs, other.xs)])

    tref._sum_flows(Rows([Sum({f}) for f in range(F)]))
    return meet


@pytest.mark.parametrize("F,L", [(56, 9), (72, 64), (128, 64)])
def test_reference_one_lane_tree_is_the_ports(F, L):
    """The trees with interleaved tail sums and with per-lane runs, at the
    link counts from which the reference takes them."""
    assert (reference_sum_tree(F, L) == port_sum_tree(F, L)).all()
