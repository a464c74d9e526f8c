#!/usr/bin/env python3
"""Probe the reference's one-lane max-min flow sum against the port's order.

    PYTHONPATH=src python3 tools/probe_flow_order.py [--flows 43-128]
        [--links 1-64] [--jobs 8] [--save FILE.npz]

For every (F, L) in the ranges, reads the tree in which XLA:CPU sums
``inc.T @ x`` over F flows and L links on one lane
(``tests/test_torch_network.py::reference_sum_tree``, one compiled call per
pair of flows) and the tree of the port's order
(``port_sum_tree``, ``repro_torch.kernels.ref._sum_flows``), and prints
every shape whose trees differ, then a count. ``--save`` keeps every
reference tree (the meet counts, uint8) for reading the forms off
offline. Exits 1 if any shape differs.

The probe is one call per pair because a batched probe (``jax.lax.map`` over
the pairs) compiles another program with another tree. Its time grows with
F squared: about 0.3 s a shape at F = 44 and 3.4 s at F = 128, about 2.4
CPU-hours for F = 43-128 over L = 1-64 (5,504 shapes). ``--jobs`` spreads
the shapes over that many worker processes, each with its own JAX; eight
take about 20 minutes. Each worker holds one small JAX CPU client.
"""
from __future__ import annotations

import argparse
import multiprocessing as mp
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _span(text: str) -> list[int]:
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def _init_worker():
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]


def _probe(shape):
    import numpy as np
    from test_torch_network import port_sum_tree, reference_sum_tree
    F, L = shape
    ref = reference_sum_tree(F, L)
    return F, L, ref.astype(np.uint8), bool((ref == port_sum_tree(F, L))
                                            .all())


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--flows", default="43-128", help="F range, as LO-HI")
    p.add_argument("--links", default="1-64", help="L range, as LO-HI")
    p.add_argument("--jobs", type=int, default=1)
    p.add_argument("--save", default=None,
                   help="write every reference tree to this .npz")
    args = p.parse_args()
    shapes = [(F, L) for F in _span(args.flows) for L in _span(args.links)]
    shapes.sort(key=lambda s: -s[0])          # the longest first
    t0 = time.perf_counter()
    trees, differ = {}, []
    ctx = mp.get_context("spawn")
    with ctx.Pool(args.jobs, initializer=_init_worker) as pool:
        for F, L, ref, same in pool.imap_unordered(_probe, shapes):
            trees[f"{F}_{L}"] = ref
            if not same:
                differ.append((F, L))
                print(f"differ F={F} L={L}", flush=True)
    if args.save:
        import numpy as np
        np.savez_compressed(args.save, **trees)
    print(f"{len(differ)} of {len(shapes)} shapes differ "
          f"({time.perf_counter() - t0:.0f} s, {args.jobs} jobs)")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
