"""The radix selection of the port's ``select_events`` kernel, step by step.

``csrc/event_select.cu::select_events_kernel`` cannot run here, so this file
models its algorithm in numpy, step for step: the order-preserving 64-bit
key, the byte passes over the keys that match the prefix (histogram, the
bin of the k-th key), the early stop once every key at or below the prefix
fits the candidate bound, the compaction in slot order (all keys under the
prefix, then the keys in it: all of them when they fit, else the first k),
and the bitonic network over the padded candidates with the kernel's
compare rule. The model is held against the port's plain
``ref.select_events`` and the JAX package's ``select_events_ref`` on
adversarial pools; ``chip_smoke.py`` holds the kernel against the plain
version on the same pools on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import select_events_ref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

T_INF = 2**31 - 1
RADIX_CAND = 1024     # the kernel's candidate buffer, one key a thread
KEY_MAX = np.uint64(2**64 - 1)


def order_key(time_key, seq):
    """Flip each int32 half's sign bit: unsigned order is (time, seq)."""
    t = (time_key.astype(np.int32).view(np.uint32) ^ np.uint32(1 << 31))
    s = (seq.astype(np.int32).view(np.uint32) ^ np.uint32(1 << 31))
    return (t.astype(np.uint64) << np.uint64(32)) | s.astype(np.uint64)


def _top(key, shift):
    return (key >> np.uint64(shift) if shift < 64
            else np.zeros_like(key))


def bitonic(keys, idx):
    """The kernel's network over n (a power of two) (key, slot) pairs:
    element e meets e ^ j and keeps the smaller pair when e's bit j and bit
    ``size`` agree, else the larger."""
    keys, idx = keys.copy(), idx.copy()
    e = np.arange(len(keys))
    size = 2
    while size <= len(keys):
        j = size // 2
        while j:
            pk, pi = keys[e ^ j], idx[e ^ j]
            p_less = (pk < keys) | ((pk == keys) & (pi < idx))
            keep_min = ((e & j) == 0) == ((e & size) == 0)
            take = p_less == keep_min
            keys, idx = np.where(take, pk, keys), np.where(take, pi, idx)
            j //= 2
        size *= 2
    return keys, idx


def radix_select_row(time_key, seq, m):
    """One agent's first m slots by the kernel's radix selection. Returns
    (slots, the number of byte passes, the number of candidates sorted,
    whether the equal keys were cut at k in slot order)."""
    cap = len(time_key)
    key = order_key(time_key, seq)
    bound = 1 << (2 * m - 1).bit_length()
    assert bound <= RADIX_CAND
    prefix, shift, k, below, eq, passes = 0, 64, m, 0, cap, 0
    while shift > 0 and below + eq > bound:
        nxt = shift - 8
        hit = _top(key, shift) == np.uint64(prefix)
        digit = ((key[hit] >> np.uint64(nxt)) & np.uint64(255)).astype(int)
        hist = np.bincount(digit, minlength=256)
        cum = np.cumsum(hist)
        b = int(np.searchsorted(cum, k))        # the bin of the k-th key
        excl = int(cum[b] - hist[b])
        prefix, shift = (prefix << 8) | b, nxt
        k, below, eq = k - excl, below + excl, int(hist[b])
        passes += 1
    cut = below + eq > bound                    # only after the last byte
    assert not cut or shift == 0
    n_eq = k if cut else eq
    top = _top(key, shift)
    lt = np.flatnonzero(top < np.uint64(prefix))
    assert len(lt) == below
    cand = np.concatenate([lt, np.flatnonzero(top == np.uint64(prefix))[:n_eq]])
    n = 1 << max(len(cand) - 1, 0).bit_length()
    ck = np.full(n, KEY_MAX, np.uint64)
    ci = np.full(n, T_INF, np.int64)
    ck[:len(cand)], ci[:len(cand)] = key[cand], cand
    _, slots = bitonic(ck, ci)
    return slots[:m].astype(np.int32), passes, len(cand), cut


def select_model(time_key, seq, exec_cap):
    """(A, cap) -> (A, min(exec_cap, cap)): the radix selection where the
    kernel runs it (2m <= min(n_pad, RADIX_CAND)), else the full sort's
    function (the bitonic path)."""
    cap = time_key.shape[1]
    m = min(exec_cap, cap)
    n_pad = 1 << max((cap - 1).bit_length(), 1)
    if 2 * m <= min(n_pad, RADIX_CAND):
        return np.stack([radix_select_row(t, s, m)[0]
                         for t, s in zip(time_key, seq)])
    key = order_key(time_key, seq)
    return np.argsort(key, axis=1, kind="stable")[:, :m].astype(np.int32)


def pool(mode, cap, rng, A=3, m=256):
    """Adversarial (A, cap) pools as the engine may hold them."""
    tk = rng.integers(0, 64, (A, cap)).astype(np.int32)
    sq = rng.integers(0, 1 << 20, (A, cap)).astype(np.int32)
    if mode == "rand":
        tk[rng.random((A, cap)) < 0.25] = T_INF
    elif mode == "unsafe":
        tk[:] = T_INF
    elif mode == "ties":
        tk[:], sq[:] = 7, 3
    elif mode == "one_time":
        tk[:] = 5
        sq = np.stack([rng.permutation(cap) for _ in range(A)]).astype(
            np.int32)
    elif mode == "neg_seq":
        sq = rng.integers(-2**31, 2**31, (A, cap)).astype(np.int32)
        tk[rng.random((A, cap)) < 0.5] = T_INF
    elif mode == "full_range":
        tk = rng.integers(-2**31, 2**31, (A, cap)).astype(np.int32)
        sq = rng.integers(-2**31, 2**31, (A, cap)).astype(np.int32)
    elif mode == "few_keys":
        # 16 distinct keys: the boundary key repeats across position m
        tk = rng.integers(0, 4, (A, cap)).astype(np.int32)
        sq = rng.integers(0, 4, (A, cap)).astype(np.int32)
    elif mode == "boundary":
        # the m-th key of a random pool copied onto 40 slots on both sides
        key = order_key(tk, sq)
        for a in range(A):
            b = np.argsort(key[a], kind="stable")[m - 1]
            at = rng.choice(cap, 40, replace=False)
            tk[a, at], sq[a, at] = tk[a, b], sq[a, b]
    return tk, sq


CASES = [  # (mode, cap, exec_cap)
    ("rand", 4096, 256), ("unsafe", 4096, 256), ("ties", 4096, 256),
    ("one_time", 4096, 256), ("neg_seq", 4096, 256), ("full_range", 4096, 256),
    ("few_keys", 4096, 256), ("boundary", 4096, 256), ("rand", 1000, 256),
    ("ties", 1000, 256), ("rand", 16384, 256), ("neg_seq", 16384, 256),
    ("few_keys", 16384, 256), ("rand", 4096, 1), ("ties", 4096, 1),
    ("rand", 4096, 512), ("boundary", 4096, 512), ("rand", 4096, 513),
    ("rand", 4096, 4096), ("ties", 1000, 1000), ("rand", 1000, 1500),
    ("rand", 1, 1), ("rand", 33, 16), ("ties", 33, 16),
]


def test_radix_selection_equals_plain_select_events():
    """The model of the kernel's selection equals the port's plain
    ``select_events`` (two stable sorts) on every adversarial pool: all
    unsafe, all equal, one time with distinct seqs, negative seqs, full
    int32 range, few keys and the boundary key repeated across position
    m; caps 1 to 16,384; m = 1, at the radix threshold (512, 513), m = cap
    and m > cap."""
    rng = np.random.default_rng(16)
    for mode, cap, xcap in CASES:
        tk, sq = pool(mode, cap, rng, m=min(xcap, cap))
        want = ref.select_events(torch.from_numpy(tk), torch.from_numpy(sq),
                                 xcap).numpy()
        np.testing.assert_array_equal(select_model(tk, sq, xcap), want,
                                      err_msg=f"{mode} cap={cap} m={xcap}")


def test_radix_selection_equals_jax_select_events_ref():
    """The same model against the JAX package's ``select_events_ref`` (one
    jitted vmap per pool shape)."""
    rng = np.random.default_rng(61)
    fns = {}
    for mode, cap, xcap in [("rand", 4096, 256), ("ties", 4096, 256),
                            ("neg_seq", 4096, 256), ("few_keys", 4096, 256),
                            ("boundary", 4096, 256), ("unsafe", 4096, 256),
                            ("rand", 1000, 256), ("one_time", 1000, 256)]:
        tk, sq = pool(mode, cap, rng)
        fn = fns.setdefault((cap, xcap), jax.jit(jax.vmap(
            lambda t, s, x=xcap: select_events_ref(t, s, x))))
        want = np.asarray(fn(jnp.asarray(tk), jnp.asarray(sq)))
        np.testing.assert_array_equal(select_model(tk, sq, xcap), want,
                                      err_msg=f"{mode} cap={cap}")


def test_radix_selection_steps():
    """The steps on their own: the key keeps the signed (time, seq) order;
    all-equal keys run all eight byte passes and cut the equal keys at k in
    slot order; a spread pool stops early with at most the bound (the
    power of two >= 2m) of candidates; the bitonic network sorts padded
    pairs by (key, slot)."""
    rng = np.random.default_rng(7)
    t = rng.integers(-2**31, 2**31, 5000).astype(np.int32)
    s = rng.integers(-2**31, 2**31, 5000).astype(np.int32)
    t[::3] = t[1::3][:len(t[::3])]
    np.testing.assert_array_equal(np.argsort(order_key(t, s), kind="stable"),
                                  np.lexsort((s, t)))

    tk, sq = pool("ties", 4096, rng, A=1)
    slots, passes, n_cand, cut = radix_select_row(tk[0], sq[0], 256)
    assert (passes, n_cand, cut) == (8, 256, True)
    np.testing.assert_array_equal(slots, np.arange(256))

    tk, sq = pool("rand", 4096, rng, A=1)
    slots, passes, n_cand, cut = radix_select_row(tk[0], sq[0], 256)
    assert passes < 8 and 256 <= n_cand <= 512 and not cut

    tk, sq = pool("rand", 100, rng, A=1)
    slots, passes, n_cand, cut = radix_select_row(tk[0], sq[0], 64)
    assert (passes, n_cand) == (0, 100)      # cap <= bound: no pass

    keys = rng.integers(0, 5, 300).astype(np.uint64)
    ck = np.concatenate([keys, np.full(212, KEY_MAX, np.uint64)])
    ci = np.concatenate([rng.permutation(300), np.full(212, T_INF)])
    sk, si = bitonic(ck, ci)
    order = np.lexsort((ci[:300], keys))
    np.testing.assert_array_equal(si[:300], ci[:300][order])
    np.testing.assert_array_equal(sk[:300], keys[order])
