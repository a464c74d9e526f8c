#!/usr/bin/env python3
"""Probe the order in which the reference sums over agents in the scheduler.

    PYTHONPATH=src python3 tools/probe_sum_order.py [--agents 33-128]

For every agent count A in the range, reads the tree in which XLA:CPU sums
a float32 vector of A values in the contexts of ``repro.core.scheduler``:
``jnp.sum`` of an (A,) vector and ``jnp.mean`` (``rebalance``), the row sums
``jnp.sum(dist * p[None, :], axis=1)`` of an (A, A) matrix
(``placement_scores``), called op by op, and the same row sums jitted inside
a ``lax.scan`` (as ``plan_placement`` runs them). The inputs reveal the
tree: every value is 1 except M = 2**40 at position i and -M at j, so M
absorbs every 1 it meets and the sum is A less the leaves under the node
where i and j meet (the row sums carry a different pair in each row). It
then checks that each tree is the port's order,
``repro_torch.core.scheduler.sum_chunks(A)``: chunks summed left to right,
the chunk totals added left to right; prints every A whose trees differ
from it (with the reference's chunks, or None where its tree has another
form), then a count, and exits 1 if any does. Beyond
``PROBED_AGENTS`` (512) the port sums left to right, so 513 on differ.
Its time grows with A cubed: 129-512 took about 1,650 s on each of four
processes (129-327, 328-408, 409-466 and 467-512).
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
M = 2.0 ** 40


def _pairs(A):
    return [(i, j) for i in range(A) for j in range(i + 1, A)]


def vector_tree(fn, A, scale=1.0):
    """Meet counts of ``fn`` over (A,) vectors, one call per pair;
    ``scale`` undoes a mean's division."""
    import jax.numpy as jnp
    meet = np.zeros((A, A), np.int64)
    for i, j in _pairs(A):
        x = np.ones(A, np.float32)
        x[i], x[j] = M, -M
        got = int(round(float(fn(jnp.asarray(x))) * scale))
        meet[i, j] = meet[j, i] = A - got
    return meet


def rows_tree(fn, A):
    """Meet counts of a row sum ``fn`` over (A, A) matrices, A pairs per
    call (row r carries the r-th pair)."""
    import jax.numpy as jnp
    pairs = _pairs(A)
    meet = np.zeros((A, A), np.int64)
    for s in range(0, len(pairs), A):
        chunk = pairs[s:s + A]
        d = np.ones((A, A), np.float32)
        for r, (i, j) in enumerate(chunk):
            d[r, i], d[r, j] = M, -M
        out = np.asarray(fn(jnp.asarray(d)))
        for r, (i, j) in enumerate(chunk):
            meet[i, j] = meet[j, i] = A - int(out[r])
    return meet


def chunk_tree(chunks):
    """Meet counts of left-to-right chunks whose totals are added left to
    right (the port's order)."""
    A = sum(chunks)
    meet = np.zeros((A, A), np.int64)
    starts = np.cumsum([0] + list(chunks))

    def add(a, b):
        for i in a:
            for j in b:
                meet[i, j] = meet[j, i] = len(a) + len(b)
        return a | b

    total = None
    for lo, hi in zip(starts[:-1], starts[1:]):
        acc = {int(lo)}
        for k in range(lo + 1, hi):
            acc = add(acc, {int(k)})
        total = acc if total is None else add(total, acc)
    return meet


def chunks_of(meet):
    """The chunk lengths of a tree of left-to-right chunks added left to
    right, read off its meet counts, or None if the tree has another form.
    Inside a chunk from ``lo``, j - 1 and j meet at the prefix of j - lo + 1
    leaves; anywhere else j starts a new chunk."""
    A = meet.shape[0]
    starts = [0]
    for j in range(1, A):
        if meet[j - 1, j] != j - starts[-1] + 1:
            starts.append(j)
    chunks = [b - a for a, b in zip(starts, starts[1:] + [A])]
    return chunks if (chunk_tree(chunks) == meet).all() else None


def probe_rows(A):
    """The tree of ``placement_scores``' row sums, called op by op."""
    import jax.numpy as jnp
    ones = jnp.ones((A,), jnp.float32)
    return rows_tree(lambda d: jnp.sum(d * ones[None, :], axis=1), A)


def probe(A):
    """Every context's tree at A agents, by name."""
    import jax
    import jax.numpy as jnp
    ones = jnp.ones((A,), jnp.float32)

    def scanned(d):
        return jax.lax.scan(lambda c, _: (c, jnp.sum(d * ones[None, :],
                                                     axis=1)),
                            0, jnp.arange(1))[1][0]

    return {
        "sum": vector_tree(jnp.sum, A),
        "mean": vector_tree(jnp.mean, A, scale=A),
        "rows": probe_rows(A),
        "scan": rows_tree(jax.jit(scanned), A),
    }


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--agents", default="33-128", help="A range, as LO-HI")
    args = p.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.scheduler import sum_chunks
    lo, _, hi = args.agents.partition("-")
    t0 = time.perf_counter()
    differ = []
    for A in range(int(lo), int(hi or lo) + 1):
        want = chunk_tree(sum_chunks(A))
        got = probe(A)
        bad = [k for k, v in got.items() if not (v == want).all()]
        if bad:
            differ.append(A)
            print(f"differ A={A} in {bad}: the reference's chunks "
                  f"{chunks_of(got['sum'])}", flush=True)
    n = int(hi or lo) - int(lo) + 1
    print(f"{len(differ)} of {n} agent counts differ "
          f"({time.perf_counter() - t0:.0f} s)")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
