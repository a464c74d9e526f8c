#!/usr/bin/env python3
"""Probe the reference's one-lane max-min flow sum against the port's order.

    PYTHONPATH=src python3 tools/probe_flow_order.py [--flows 43-128]
        [--links 1-64] [--sample N] [--sample-from LO-HI] [--packed]
        [--tree] [--fit] [--jobs 8] [--save FILE.npz]

For every (F, L) in the ranges, reads the tree in which XLA:CPU sums
``inc.T @ x`` over F flows and L links on one lane
(``tests/test_torch_network.py::reference_sum_tree``, one compiled call per
pair of flows) and the tree of the port's order
(``port_sum_tree``, ``repro_torch.kernels.ref._sum_flows``), and prints
every shape whose trees differ, then a count. ``--links`` takes ranges and
single values separated by commas (``1,2,8,9,64``); ``--sample N`` adds, for
each F, N values of L drawn from a generator seeded with F out of the
interiors of the ranges the table's L-ranges break at (3-7 and 10 up to the
largest L given, less one), or out of ``--sample-from``. ``--packed`` reads
L pairs a compiled call, pair k on link k
(``tests/test_torch_flow_order.py::reference_meet``), about L times faster.
``--tree`` (with ``--packed``) reads only the pairs that build the tree
(``tree_meet``): the first flow of each node against the node's other
flows, so about F log F pairs in place of F^2 / 2; every other count is
the size of the node where the pair splits, and a read that is not a
node's size stops the probe. ``--fit`` names, for each shape whose tree
is not the port's, the ``FlowOrder`` whose tree is the reference's (``fit_order``: the block order read off lane 0, then
every chain count, tail width and trailing count), or "none", and prints
each F's L-ranges of one order. ``--save`` keeps every reference tree (the
meet counts, uint16) for reading the forms off offline, and ``--load``
checks the trees of such a file against the port's order (and fits those
that differ) without probing. Exits 1 if any shape
differs.

The unpacked probe is one call per pair because a batched probe
(``jax.lax.map`` over the pairs) compiles another program with another
tree. Its time grows with F squared: about 0.3 s a shape at F = 44 and
3.4 s at F = 128, about 2.4 CPU-hours for F = 43-128 over L = 1-64 (5,504
shapes). ``--jobs`` spreads the shapes over that many worker processes,
each with its own JAX; eight take about 20 minutes. Each worker holds one
small JAX CPU client.
"""
from __future__ import annotations

import argparse
import multiprocessing as mp
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _span(text: str) -> list[int]:
    """``1-4,9,64`` -> [1, 2, 3, 4, 9, 64]."""
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += range(int(lo), int(hi or lo) + 1)
    return sorted(set(out))


def _sampled(F: int, links: list[int], n: int,
             among: list[int] | None = None) -> list[int]:
    """``links`` and ``n`` more values of L, seeded by F, from ``among``
    (default 3-7 and 10 .. max(links) - 1)."""
    import numpy as np
    rng = np.random.default_rng(F)
    pool = [L for L in (among or (*range(3, 8), *range(10, max(links))))
            if L not in links]
    extra = rng.choice(pool, size=min(n, len(pool)), replace=False)
    return sorted(set(links) | {int(L) for L in extra})


def _init_worker():
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]


def packed_tree(F, L):
    """The reference's meet counts of every pair, L pairs a call."""
    import numpy as np
    from test_torch_flow_order import reference_meet
    pairs = [(i, j) for i in range(F) for j in range(i + 1, F)]
    meet = np.zeros((F, F), np.int64)
    for (i, j), m in zip(pairs, reference_meet(F, L, pairs)):
        meet[i, j] = meet[j, i] = m
    return meet


def tree_meet(F, L):
    """The reference's meet counts of every pair, read node by node, L
    pairs a call: a node of n flows whose first flow is a splits into a
    and the flows that meet a under n leaves, and the rest, each of which
    must meet a at exactly n. The left part keeps a, so only the right
    part's first flow reads anew."""
    import numpy as np
    from test_torch_flow_order import reference_meet
    meet = np.zeros((F, F), np.int64)
    known, nodes = {}, [list(range(F))]
    while nodes:
        need = [(s[0], j) for s in nodes for j in s[1:]
                if (s[0], j) not in known]
        known.update(zip(need, reference_meet(F, L, need)))
        split = []
        for s in nodes:
            n, a = len(s), s[0]
            left = [a] + [j for j in s[1:] if known[(a, j)] < n]
            right = [j for j in s[1:] if known[(a, j)] >= n]
            if not right or any(known[(a, j)] != n for j in right):
                raise RuntimeError(f"F={F} L={L}: flow {a}'s meets in a "
                                   f"node of {n} are not a tree's")
            meet[np.ix_(left, right)] = n
            meet[np.ix_(right, left)] = n
            split += [t for t in (left, right) if len(t) > 1]
        nodes = split
    return meet


def _probe(job):
    import numpy as np
    from test_torch_network import port_sum_tree, reference_sum_tree
    F, L, packed = job
    ref = (packed_tree(F, L) if packed == "full" else tree_meet(F, L)
           if packed == "tree" else reference_sum_tree(F, L))
    return F, L, ref.astype(np.uint16), bool((ref == port_sum_tree(F, L))
                                             .all())


# ---------------------------------------------------------------- fitting
def order_tree(F: int, order) -> "np.ndarray":
    """The meet counts of ``_sum_flows`` in ``order`` over F flows."""
    from test_torch_network import port_sum_tree
    from repro_torch.kernels import ref as tref
    saved = tref.flow_order
    tref.flow_order = lambda *_: order
    try:
        return port_sum_tree(F, 1)
    finally:
        tref.flow_order = saved


def _lane0_blocks(meet, V: int, chains: int):
    """The block order of lane 0 (flows 8b, b < V / 8) in ``chains`` runs,
    read off the meet counts: within a run, the flow at position q meets
    the earlier ones at q + 1 leaves; runs meet later, at (c + 1) * run."""
    n = V // 8
    if n % chains:
        return None
    run = n // chains
    flows = list(range(0, V, 8))
    # runs: the flows within ``run`` leaves of each other
    runs, left = [], set(flows)
    while left:
        a = min(left)
        grp = [b for b in sorted(left) if b == a or meet[a, b] <= run]
        if len(grp) != run:
            return None
        runs.append(grp)
        left -= set(grp)
    # the runs in the order they join: run r >= 1 meets the earlier ones
    # at (r + 1) * run leaves
    if chains > 1:
        every = tuple(runs)
        runs.sort(key=lambda g: min(meet[g[0], h[0]] for h in every
                                    if h is not g))
    blocks = []
    for grp in runs:
        key = {b: min(meet[b, a] for a in grp if a != b) if run > 1 else 1
               for b in grp}
        blocks += [b // 8 for b in sorted(grp, key=lambda b: (key[b], b))]
    return tuple(blocks)


def _trailing(meet) -> int:
    """The largest t such that each of the last t flows meets every
    earlier flow at its own position + 1 leaves (added one at a time)."""
    F = meet.shape[0]
    t = 0
    while t < F - 1 and (meet[F - 1 - t, :F - 1 - t] == F - t).all():
        t += 1
    return t


def fit_order(meet):
    """The ``FlowOrder`` whose tree over F = len(meet) flows is ``meet``, or
    None. Heads are tried at every multiple of 8 from 16 up to F with 1, 2,
    4 or 8 runs, the block order read off lane 0, the head's own tree
    checked first; then 1, 2, 4, 8 or 16 tail lanes, the trailing count
    read off the last flows (one tail lane sums in order, so it takes
    none)."""
    import numpy as np
    from repro_torch.kernels.ref import LEFT_TO_RIGHT, FlowOrder
    F = meet.shape[0]
    meet = np.asarray(meet, np.int64)
    if (order_tree(F, LEFT_TO_RIGHT) == meet).all():
        return LEFT_TO_RIGHT
    t = _trailing(meet)
    for V in range(16, F + 1, 8):
        for chains in (1, 2, 4, 8):
            blocks = _lane0_blocks(meet, V, chains)
            if blocks is None or sorted(blocks) != list(range(V // 8)):
                continue
            head = FlowOrder(V, blocks, chains)
            if not (order_tree(V, head) == meet[:V, :V]).all():
                continue
            for W in (1, 2, 4, 8, 16):
                for T in ((0,) if W == 1 else (t, t - 1)):
                    tail = F - V - T
                    if T < 0 or tail < 0 or (W > 1 and (tail < W
                                                        or tail % W)):
                        continue
                    order = head._replace(tail_lanes=W, trailing=T)
                    if (order_tree(F, order) == meet).all():
                        return order
    return None


def _same(job):
    import numpy as np
    from test_torch_network import port_sum_tree
    F, L, meet = job
    return F, L, bool((np.asarray(meet, np.int64) == port_sum_tree(F, L))
                      .all())


def _fit(job):
    F, L, meet = job
    return F, L, fit_order(meet)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--flows", default="43-128", help="F values, as LO-HI,...")
    p.add_argument("--links", default="1-64", help="L values, as LO-HI,...")
    p.add_argument("--sample", type=int, default=0,
                   help="per F, this many more L in the ranges' interiors")
    p.add_argument("--sample-from", default=None,
                   help="draw the sample from these L (LO-HI,...)")
    p.add_argument("--packed", action="store_true",
                   help="read L pairs a compiled call")
    p.add_argument("--tree", action="store_true",
                   help="with --packed, read only the pairs of each node")
    p.add_argument("--fit", action="store_true",
                   help="name each shape's order and print the L-ranges")
    p.add_argument("--jobs", type=int, default=1)
    p.add_argument("--save", default=None,
                   help="write every reference tree to this .npz")
    p.add_argument("--load", default=None,
                   help="fit the trees of this .npz (from --save), no probe")
    args = p.parse_args()
    links = _span(args.links)
    among = _span(args.sample_from) if args.sample_from else None
    packed = ("tree" if args.tree else "full") if args.packed else None
    shapes = [(F, L, packed) for F in _span(args.flows)
              for L in (_sampled(F, links, args.sample, among)
                        if args.sample else links)]
    shapes.sort(key=lambda s: -s[0])          # the longest first
    t0 = time.perf_counter()
    trees, differ = {}, []
    ctx = mp.get_context("spawn")
    with ctx.Pool(args.jobs, initializer=_init_worker) as pool:
        if args.load:
            import numpy as np
            with np.load(args.load) as blob:
                trees = {tuple(map(int, k.split("_"))): blob[k]
                         for k in blob.files}
            for F, L, same in pool.imap_unordered(
                    _same, [(F, L, t) for (F, L), t in trees.items()]):
                if not same:
                    differ.append((F, L))
                    print(f"differ F={F} L={L}", flush=True)
        for F, L, ref, same in pool.imap_unordered(
                _probe, [] if args.load else shapes):
            trees[(F, L)] = ref
            if not same:
                differ.append((F, L))
                print(f"differ F={F} L={L}", flush=True)
        if args.save:
            import numpy as np
            np.savez_compressed(args.save, **{f"{F}_{L}": t
                                              for (F, L), t in trees.items()})
        if args.fit:
            # a shape whose tree is the port's takes the port's order
            from repro_torch.kernels.ref import flow_order
            search = set(differ)
            fits = {(F, L): flow_order(F, L, 1) for F, L in trees
                    if (F, L) not in search}
            for F, L, order in pool.imap_unordered(
                    _fit, [(F, L, t) for (F, L), t in trees.items()
                           if (F, L) in search]):
                fits[(F, L)] = order
            for F in sorted({F for F, _ in fits}):
                row = sorted((L, o) for (G, L), o in fits.items() if G == F)
                spans = []
                for L, o in row:
                    if spans and spans[-1][2] == o:
                        spans[-1][1] = L
                    else:
                        spans.append([L, L, o])
                print(f"fit F={F}: " + "; ".join(
                    f"L {lo}-{hi} {o}" for lo, hi, o in spans), flush=True)
    print(f"{len(differ)} of {len(trees)} shapes differ "
          f"({time.perf_counter() - t0:.0f} s, {args.jobs} jobs)")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
