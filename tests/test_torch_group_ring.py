"""The port's ``group_by_kind`` and ``ring_slots`` kernels, step by step.

``csrc/event_select.cu`` cannot run here, so this file models the two
kernels' algorithms in numpy, step for step, and holds the models against
the port's plain ``ref.group_by_kind``/``ref.ring_slots`` and the JAX
package's ``group_by_kind_xla``/``ring_slots_ref``:

- ``group_by_kind_kernel``: warp w owns a contiguous segment of 32-row
  steps; per step a row's peers (the lanes of its key: ``__match_any_sync``)
  give its rank among them and the group's lowest lane adds the group's size
  to the warp's row of counts; after the one barrier lane g of each warp sums
  column g (rows of key g in earlier warps and in all), a shuffle scan over
  the keys gives the key starts (key 32 from lane 31's inclusive sum), and
  every row goes to its key's next position in its warp plus its rank;
- ``ring_slots_kernel``: four rows a thread, the groups aligned to the mask's
  32-bit words (``lead`` rows of the first word belong to the row before),
  the counts by popc, a warp shuffle scan and a scan of the warp totals, a
  carry across tiles, and the ring position advanced by one a wanted row
  with a compare for the wrap at cap, worked out again where head + rank
  steps over the int32 range.

``chip_smoke.py`` holds the kernels against the plain versions on the card
on the same cases.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.engine import group_by_kind_xla  # noqa: E402
from repro.kernels.ref import ring_slots_ref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

I32_MIN, I32_MAX = -2**31, 2**31 - 1


def threads_for(n):
    """The launchers' block size: the least power of two >= n in [32,
    1024]."""
    t = 32
    while t < n and t < 1024:
        t *= 2
    return t


def lanes_below(keys):
    """Per lane of (..., 32) keys: its peers (lanes of the same key) below
    it, and the size of its group (``__popc(peers & lt)``, ``__popc(peers)``)
    and whether it is the group's lowest lane."""
    same = keys[..., :, None] == keys[..., None, :]
    below = np.tril(np.ones((32, 32), bool), -1)   # [l, l2]: l2 < l
    r = (same & below).sum(-1)
    return r, same.sum(-1), r == 0


def group_model(kind, active, n_kinds):
    """``group_by_kind_kernel`` on one agent's (m,) rows."""
    m = kind.shape[0]
    block = threads_for(m)
    n_warps, steps = block // 32, -(-m // block)
    n_keys = n_kinds + 1
    i = (np.arange(n_warps)[:, None, None] * steps * 32
         + np.arange(steps)[None, :, None] * 32 + np.arange(32))
    key = np.full(i.shape, -1)
    ok = i < m
    key[ok] = np.where(active[i[ok]] != 0,
                       np.clip(kind[i[ok]], 0, n_kinds - 1), n_kinds)
    r, size, leader = lanes_below(key)

    # 1. each warp's row of counts, one add a group leader
    cnt = np.zeros((n_warps, n_keys), np.int64)
    w_idx = np.broadcast_to(np.arange(n_warps)[:, None, None], key.shape)
    lead_ok = leader & (key >= 0)
    np.add.at(cnt, (w_idx[lead_ok], key[lead_ok]), size[lead_ok])

    # 2. lane g of warp w: rows of key g before warp w and in all; starts by
    # a scan over lanes 0..31, key 32 starting at lane 31's inclusive sum
    col = np.zeros((n_warps, 64), np.int64)
    col[:, :n_keys] = cnt
    before = np.cumsum(col, 0) - col
    tot = col.sum(0)
    incl = np.cumsum(tot[:32])
    start = np.concatenate([incl - tot[:32], [incl[31]]])
    pos = start[None, :n_keys] + before[:, :n_keys]
    counts = tot[:n_kinds]

    # 3. placement, step by step, the leaders moving their key's position
    order = np.full(m, -1, np.int64)
    rank = np.full(m, -1, np.int64)
    for s in range(steps):
        for w in range(n_warps):
            k, rows = key[w, s], i[w, s]
            live = k >= 0
            p = pos[w, k[live]] + r[w, s][live]
            order[p] = rows[live]
            rank[p] = p - start[k[live]]
            lw = leader[w, s] & live
            pos[w, k[lw]] += size[w, s][lw]
    assert (order >= 0).all() and (rank >= 0).all()
    return order, rank, counts


def floor_mod(x, cap):
    return x - (x // cap) * cap


def wrap32(x):
    return (np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31


def ring_model(ring, head, want, lead, recompute=True):
    """``ring_slots_kernel`` on one agent: (cap,) ring, scalar head, (n,)
    mask whose first row sits ``lead`` bytes into an aligned word. Returns
    the slots and whether a thread stepped over the int32 range."""
    cap, n = ring.shape[0], want.shape[0]
    block = threads_for(n // 4 + 1)
    n_groups = (n + lead + 3) // 4
    out = np.full(n, -1, np.int64)
    carry, crossed = 0, False
    for base in range(0, n_groups, block):
        k = base + np.arange(block)
        rows = 4 * k[:, None] - lead + np.arange(4)      # (block, 4)
        valid = (rows >= 0) & (rows < n) & (k[:, None] < n_groups)
        wanted = np.zeros(rows.shape, bool)
        wanted[valid] = want[rows[valid]] != 0
        c = wanted.sum(1).reshape(-1, 32)
        incl = np.cumsum(c, 1)
        warp_incl = np.cumsum(incl[:, -1])
        warp_before = np.concatenate([[0], warp_incl[:-1]])
        rank = (carry + incl - c + warp_before[:, None]).reshape(-1)
        carry += int(warp_incl[-1])
        x = wrap32(head + rank)
        p = floor_mod(x, cap)
        for j in range(4):
            v = valid[:, j]
            out[rows[v, j]] = ring[p[v]]
            step = wanted[:, j]
            x = np.where(step, wrap32(x + 1), x)
            at_min = step & (x == I32_MIN)
            crossed |= bool(at_min.any())
            nxt = np.where(p + 1 == cap, 0, p + 1)
            if recompute:
                nxt = np.where(at_min, floor_mod(x, cap), nxt)
            p = np.where(step, nxt, p)
    assert (out >= 0).all()
    return out, crossed


def _group_inputs(rng, A, m, n_kinds, mode):
    kind = rng.integers(-3, n_kinds + 3, (A, m)).astype(np.int32)
    active = rng.random((A, m)) < 0.6
    if mode == "inactive":
        active[:] = False
    elif mode == "one_kind":
        kind[:], active[:] = 3, True
    return kind, active


def test_group_model_matches_ref_and_jax():
    """Rows of 1 to 4096 (one 32-row step a warp up to 1024, then segments
    of several), 2, 9 and 33 keys, kinds out of range, no active row, one
    kind; the model equals the plain version with any mask dtype, and the
    plain version equals JAX's ``group_by_kind_xla`` at one shape."""
    rng = np.random.default_rng(19)
    A = 2
    for n_kinds in (1, 8, 32):
        for m in (1, 31, 32, 33, 256, 1000, 1024, 1025, 4096):
            for mode in ("rand", "inactive", "one_kind"):
                kind, active = _group_inputs(rng, A, m, n_kinds, mode)
                want = ref.group_by_kind(torch.from_numpy(kind),
                                         torch.from_numpy(active), n_kinds)
                for mask in (active, active.astype(np.uint8),
                             active.astype(np.int32)):
                    for a in range(A):
                        got = group_model(kind[a], mask[a], n_kinds)
                        for g, w in zip(got, want):
                            np.testing.assert_array_equal(
                                g, w[a].numpy(),
                                err_msg=f"n_kinds={n_kinds} m={m} {mode}")
    kind, active = _group_inputs(rng, 1, 1025, 8, "rand")
    jax_out = jax.jit(group_by_kind_xla, static_argnums=2)(
        jnp.asarray(kind[0]), jnp.asarray(active[0]), 8)
    want = ref.group_by_kind(torch.from_numpy(kind), torch.from_numpy(active),
                             8)
    for g, w, j in zip(group_model(kind[0], active[0], 8), want, jax_out):
        np.testing.assert_array_equal(g, w[0].numpy())
        np.testing.assert_array_equal(g, np.asarray(j))


def test_ring_model_matches_ref_and_jax():
    """n of 1 to 12289 (several tiles), the mask starting 0 to 3 bytes into
    a word, heads near the ring's end, negative, and near 2^31 - 1 over a
    ring whose size does not divide 2^32 (there the int32 wrap moves the
    floor modulo, and the model without its recompute is wrong); want all,
    none and random. The model equals the plain version, and the plain
    version equals JAX's ``ring_slots_ref`` at one shape."""
    rng = np.random.default_rng(7)
    crossings = naive_wrong = 0
    for cap in (4096, 3001):
        ring = rng.permutation(cap).astype(np.int32)
        for n in (1, 3, 4095, 4096, 4097, 12289):
            for head in (cap - 3, -5, I32_MAX - 40, I32_MAX - n // 2):
                for mode in ("all", "none", "rand"):
                    want = {"all": np.ones(n, bool), "none": np.zeros(n, bool),
                            "rand": rng.random(n) < 0.5}[mode]
                    ref_out = ref.ring_slots(
                        torch.from_numpy(ring[None]),
                        torch.tensor([head], dtype=torch.int32),
                        torch.from_numpy(want[None]))[0].numpy()
                    for lead in range(4):
                        got, crossed = ring_model(ring, head, want, lead)
                        np.testing.assert_array_equal(
                            got, ref_out, err_msg=f"cap={cap} n={n} "
                            f"head={head} {mode} lead={lead}")
                        crossings += crossed
                        if crossed:
                            naive, _ = ring_model(ring, head, want, lead,
                                                  recompute=False)
                            naive_wrong += not np.array_equal(naive, ref_out)
    assert crossings > 0 and naive_wrong > 0
    ring = rng.permutation(3001).astype(np.int32)
    want = rng.random(4097) < 0.5
    head = np.int32(I32_MAX - 1000)
    jax_out = jax.jit(ring_slots_ref)(jnp.asarray(ring), jnp.asarray(head),
                                      jnp.asarray(want))
    got, crossed = ring_model(ring, int(head), want, 1)
    assert crossed
    np.testing.assert_array_equal(got, np.asarray(jax_out))
    np.testing.assert_array_equal(got, ref.ring_slots(
        torch.from_numpy(ring[None]), torch.tensor([head]),
        torch.from_numpy(want[None]))[0].numpy())


def test_ops_group_by_kind_takes_each_mask_dtype_on_the_cpu():
    """``ops.group_by_kind`` on CPU tensors: bool, uint8 and int32 masks
    (the card takes all three as they come) give one result, the plain
    version's."""
    rng = np.random.default_rng(3)
    kind, active = _group_inputs(rng, 3, 300, 8, "rand")
    kind = torch.from_numpy(kind)
    results = [ops.group_by_kind(kind, torch.from_numpy(active).to(dt), 8)
               for dt in (torch.bool, torch.uint8, torch.int32)]
    want = ref.group_by_kind(kind, torch.from_numpy(active), 8)
    for got in results:
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and torch.equal(g, w)
