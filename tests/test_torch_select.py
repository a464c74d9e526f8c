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
version on the same pools on the card. ``fused_select_kernel``'s flow is
modelled on top of it: the same selection, the gather, the conflict rule
(the window's (rkey, not a candidate) keys sorted by the same networks, a
candidate dirty when a sorted neighbour shares its key), the grouping and
the release positions, held against ``ref.fused_select``'s pairwise count.
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


def fused_model(cols, exec_cap, n_kinds, n_res):
    """``fused_select`` as the kernel computes it, one agent at a time:
    the selection (``select_model``), the gather, conflicts by sorting the
    lanes' (rkey, not a candidate) keys (the bitonic network with entries
    lane | flags << 16 on the radix path, the same total order on the
    sort path) and comparing sorted neighbours, the stable grouping of the
    clean lanes by kind, and the release positions."""
    (tk, sq, safe, time, kind, src, dst, ctx, payload, valid, table_id, res,
     free_tail) = cols
    A, cap = tk.shape
    m = max(min(exec_cap, cap), 1)
    n_pad = 1 << max((cap - 1).bit_length(), 1)
    radix = 2 * m <= min(n_pad, RADIX_CAND)
    idx = select_model(tk, sq, m)
    rows = np.arange(A)[:, None]
    es = safe[rows, idx]
    tb = table_id[rows, idx]
    rkey = (tb.astype(np.uint32) * np.uint32(n_res)
            + res[rows, idx].astype(np.uint32))
    kd = np.clip(kind[rows, idx], 0, n_kinds - 1)
    cand = es & (tb > 0)
    fl = es.astype(np.int64) | cand.astype(np.int64) << 1 | kd << 8
    n = 1 << max(m - 1, 0).bit_length()
    clean = np.zeros((A, m), bool)
    for a in range(A):
        key = rkey[a].astype(np.uint64) << np.uint64(1) | (~cand[a]).astype(
            np.uint64)
        ent = np.arange(m) | fl[a] << 16
        if radix:
            sk = np.full(n, KEY_MAX, np.uint64)
            si = np.full(n, T_INF, np.int64)
            sk[:m], si[:m] = key, ent
            sk, si = bitonic(sk, si)
        else:
            o = np.lexsort((ent, ~cand[a], rkey[a]))
            sk, si = key[o], ent[o]
        # past the last lane: a pad (or nothing), never a lane's key
        sk, si = np.append(sk[:m], KEY_MAX), si[:m]
        same = np.zeros(m, bool)
        same[1:] |= sk[1:m] == sk[:m - 1]
        same[:m] |= sk[1:m + 1] == sk[:m]
        dirty = (sk[:m] & np.uint64(1) == 0) & same
        lane, f = si & 0xffff, si >> 16
        clean[a, lane] = (f & 1).astype(bool) & ~dirty
    gk = np.where(clean, kd, n_kinds)
    order = np.argsort(gk, axis=1, kind="stable").astype(np.int32)
    counts = np.stack([np.bincount(g, minlength=n_kinds + 1)[:n_kinds]
                       for g in gk]).astype(np.int32)
    excl = np.cumsum(es, axis=1) - es
    rel = ((free_tail[:, None].astype(np.int64) + excl) % cap).astype(
        np.int32)
    fields = dict(exec_idx=idx, exec_safe=es, time=time[rows, idx],
                  seq=sq[rows, idx], kind=kind[rows, idx],
                  src=src[rows, idx], dst=dst[rows, idx],
                  ctx=ctx[rows, idx], payload=payload[rows, idx],
                  valid=valid[rows, idx], clean=clean, order=order,
                  rel_pos=rel)
    return fields, counts


def test_fused_select_flow_equals_plain_fused_select():
    """The model of the fused kernel's flow equals the port's plain
    ``fused_select`` (the pairwise conflict count) on every pool of CASES,
    the radix and the sort path, with the other columns drawn from a seed:
    conflicts likely (4 tables x 8 resources), unsafe and invalid slots,
    kinds out of range, NaN payload words compared by bits."""
    rng = np.random.default_rng(23)
    n_kinds, n_res = 8, 8
    for mode, cap, xcap in CASES:
        tk, sq = pool(mode, cap, rng, m=min(xcap, cap))
        A = tk.shape[0]

        def ri(lo, hi):
            return rng.integers(lo, hi, (A, cap)).astype(np.int32)

        payload = rng.standard_normal((A, cap, 2)).astype(np.float32)
        payload[:, ::5, 1] = np.nan
        cols = (tk, sq, rng.random((A, cap)) < 0.6, ri(0, 50), ri(-1, 10),
                ri(0, 16), ri(0, 16), ri(0, 4), payload,
                rng.random((A, cap)) < 0.8, ri(0, 4), ri(0, 8),
                rng.integers(0, cap, A).astype(np.int32))
        got, got_counts = fused_model(cols, xcap, n_kinds, n_res)
        want, want_counts = ref.fused_select(
            *(torch.from_numpy(np.ascontiguousarray(c)) for c in cols), xcap,
            n_kinds=n_kinds, n_res=n_res)
        msg = f"{mode} cap={cap} m={xcap}"
        np.testing.assert_array_equal(got_counts, want_counts.numpy(),
                                      err_msg=msg)
        for name in want._fields:
            w = getattr(want, name).numpy()
            g = np.asarray(got[name])
            if w.dtype == np.float32:
                w, g = w.view(np.int32), g.view(np.int32)
            np.testing.assert_array_equal(g, w, err_msg=f"{msg} {name}")
