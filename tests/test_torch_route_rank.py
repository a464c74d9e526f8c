"""The port's ``route_rank`` kernel, step by step.

``csrc/event_select.cu`` cannot run here, so this file models
``route_rank_kernel`` in numpy, step for step, and holds the model against
the port's plain ``ref.route_rank`` and the JAX package's
``route_rank_xla``:

- warp w owns the contiguous segment of ``steps`` 32-row steps from row
  ``32 * steps * w`` (``steps = ceil(n / block)``, the block the least
  power of two >= n in [32, 1024]);
- per step (``walk_step``) a row's peers are the lanes of its key
  (``__match_any_sync``); the group's lowest lane reads the warp's running
  count of the key, adds the group's size and hands what it read to its
  peers (a shuffle), so a row's rank in its warp is that count plus its
  peers below its lane; a key outside ``[0, n_buckets)`` reads and moves
  nothing;
- after the one barrier, lane g sums column g of the earlier warps' counts
  (and column g + 32 when there are more than 32 buckets), and a row adds
  the sum of its key, taken from lane ``key & 31``;
- up to four steps keep their keys and ranks in registers; more steps walk
  the segment again from the earlier warps' counts.

``chip_smoke.py`` holds the kernel against the plain version on the card on
the same cases.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.engine import route_rank_xla  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

MAX_KEYS = 64      # the kernel's table: csrc/event_select.cu MAX_KEYS
KEPT = 4           # steps kept in registers: ROUTE_KEPT
SIZES = (1, 31, 32, 33, 1000, 1024, 1025, 4096, 4097, 12289)
BUCKETS = (1, 2, 9, 33, 64)
MODES = ("uniform", "sentinel", "one_key", "valid_0", "valid_6",
         "valid_4096")
BELOW = np.tril(np.ones((32, 32), bool), -1)   # [l, l2]: lane l2 < l


def threads_for(n):
    t = 32
    while t < n and t < 1024:
        t *= 2
    return t


def walk_step(key, n_keys, run):
    """One step of every warp: (n_warps, 32) keys, (n_warps, MAX_KEYS)
    running counts (moved in place). Returns each lane's rank among the
    rows of its key that its warp has walked."""
    same = key[:, :, None] == key[:, None, :]                 # the peers
    below = (same & BELOW).sum(-1)
    size = same.sum(-1)
    leader = same.argmax(-1)                                  # __ffs - 1
    ok = (key >= 0) & (key < n_keys)
    w = np.broadcast_to(np.arange(key.shape[0])[:, None], key.shape)
    lead = (leader == np.arange(32)) & ok
    seen = np.zeros(key.shape, np.int64)
    seen[lead] = run[w[lead], key[lead]]                      # the read
    run[w[lead], key[lead]] += size[lead]                     # the move
    seen = np.take_along_axis(seen, leader, -1)               # the shuffle
    return seen + below


def route_model(dst, n_buckets):
    """``route_rank_kernel`` on one agent's (n,) keys."""
    n = dst.shape[0]
    block = threads_for(n)
    n_warps, steps = block // 32, -(-n // block)
    i = (np.arange(n_warps)[:, None, None] * steps * 32
         + np.arange(steps)[None, :, None] * 32 + np.arange(32))
    key = np.where(i < n, dst[np.minimum(i, n - 1)], -1).astype(np.int64)
    out = np.full(n, -1, np.int64)

    # 1. each warp's running counts, and (kept) each row's rank in its warp
    cnt = np.zeros((n_warps, MAX_KEYS), np.int64)
    in_warp = [walk_step(key[:, s], n_buckets, cnt) for s in range(steps)]

    # 2. lane g: key g's rows in earlier warps, key g + 32's when wide
    before = np.cumsum(cnt, 0) - cnt
    before0 = before[:, :32]
    before1 = before[:, 32:] if n_buckets > 32 else np.zeros_like(before0)
    if steps <= KEPT:
        for s in range(steps):
            k = key[:, s]
            src = k & 31
            b = np.take_along_axis(before0, src, -1)
            if n_buckets > 32:
                b = np.where(k >= 32, np.take_along_axis(before1, src, -1),
                             b)
            live = i[:, s] < n
            out[i[:, s][live]] = (in_warp[s] + b)[live]
    else:   # walk again from the earlier warps' counts, in a second table
        pos = np.concatenate([before0, before1], 1)
        for s in range(steps):
            r = walk_step(key[:, s], n_buckets, pos)
            live = i[:, s] < n
            out[i[:, s][live]] = r[live]
    assert (out >= 0).all()
    return out


def route_inputs(rng, A, n, n_buckets, mode):
    """(A, n) int32 buckets: uniform; all the sentinel (n_buckets - 1); one
    key; the engine's compaction (k valid rows first, the rest the
    sentinel)."""
    sentinel = n_buckets - 1
    if mode == "uniform":
        return rng.integers(0, n_buckets, (A, n)).astype(np.int32)
    if mode == "sentinel":
        return np.full((A, n), sentinel, np.int32)
    if mode == "one_key":
        return np.full((A, n), n_buckets // 2, np.int32)
    k = min(int(mode.split("_")[1]), n)
    d = np.full((A, n), sentinel, np.int32)
    d[:, :k] = rng.integers(0, max(sentinel, 1), (A, k))
    return d


def test_route_model_matches_ref():
    """n of 1 to 12289 (one 32-row step a warp up to 1024, kept steps up to
    4096, two walks above), 1, 2, 9, 33 and 64 buckets, uniform keys, all
    sentinel, one key and the engine's compaction; then keys outside the
    contract, which change no other row's rank."""
    rng = np.random.default_rng(20)
    for n in SIZES:
        for nb in BUCKETS:
            for mode in MODES:
                dst = route_inputs(rng, 1, n, nb, mode)
                want = ref.route_rank(torch.from_numpy(dst))[0].numpy()
                np.testing.assert_array_equal(
                    route_model(dst[0], nb), want,
                    err_msg=f"n={n} n_buckets={nb} {mode}")
    for n, nb in ((4096, 9), (12289, 33), (1000, 64)):
        dst = rng.integers(0, nb, n).astype(np.int32)
        bad = rng.random(n) < 0.1
        dst[bad] = rng.choice([-7, -1, nb, nb + 40, 2**31 - 1], bad.sum())
        got = route_model(dst, nb)
        want = ref.route_rank(torch.from_numpy(dst[None]))[0].numpy()
        np.testing.assert_array_equal(got[~bad], want[~bad])


def test_route_model_matches_jax_route_rank_xla():
    """The model equals the JAX package's engine default at the engine's
    shape (4,096 emits, 9 buckets, 6 valid rows first) and at a wide
    table over two walks."""
    rng = np.random.default_rng(8)
    fn = jax.jit(route_rank_xla)
    for n, nb, mode in ((4096, 9, "valid_6"), (4097, 33, "uniform")):
        dst = route_inputs(rng, 1, n, nb, mode)[0]
        np.testing.assert_array_equal(route_model(dst, nb),
                                      np.asarray(fn(jnp.asarray(dst))))


def test_ops_route_rank_on_the_cpu():
    """``ops.route_rank`` on CPU tensors is the plain version, for the
    engine's int32 buckets and for other integer dtypes; it launches no
    kernel."""
    from repro_torch.kernels import event_select as es
    rng = np.random.default_rng(4)
    dst = torch.from_numpy(route_inputs(rng, 3, 1025, 9, "valid_6"))
    es.reset_launches()
    want = ref.route_rank(dst)
    for dt in (torch.int32, torch.int64):
        got = ops.route_rank(dst.to(dt), 9)
        assert got.dtype == torch.int32 and torch.equal(got, want)
    assert es.LAUNCHES["route_rank"] == 0
