"""The port's window front-end kernels, plain versions against the reference.

Each plain PyTorch version in ``repro_torch.kernels.ref`` is held byte for
byte against the JAX Pallas kernel run with ``interpret=True`` (as
tests/test_kernels.py runs it) and against its XLA twin, on seeded numpy
inputs: ties, all-unsafe pools, caps that are not powers of two,
``exec_cap > cap``, ring cursors that wrap and windows with no safe slot.
``fused_select`` runs half its reference cases in
``tests/test_torch_fused_xla.py`` and its Pallas case in
``tests/test_torch_eager_refs.py``, files of at most 3 tests.
The CUDA kernels themselves need the card; chip_smoke.py holds them
against these plain versions there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several worker processes on one machine: keep torch to one
# thread each, as the tensors here are small
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.kernels import event_select as jes  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.kernels import event_select as es  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

T_INF = 2**31 - 1
A = 2


def _select_inputs(cap, mode, seed):
    rng = np.random.default_rng(seed)
    tk = rng.integers(0, 12, (A, cap)).astype(np.int32)
    sq = rng.integers(0, 40, (A, cap)).astype(np.int32)
    if mode == "rand":
        tk[rng.random((A, cap)) < 0.3] = T_INF
    elif mode == "unsafe":
        tk[:] = T_INF
    elif mode == "ties":
        tk[:] = 5
        sq[:] = 9
    return tk, sq


@pytest.mark.parametrize("cap,exec_cap,mode", [
    (64, 16, "rand"), (100, 33, "rand"), (24, 24, "ties"),
    (20, 30, "unsafe"), (40, 30, "rand")])
def test_select_events_matches_pallas_and_xla(cap, exec_cap, mode):
    tk, sq = _select_inputs(cap, mode, cap * 7 + exec_cap)
    got = ref.select_events(torch.from_numpy(tk), torch.from_numpy(sq),
                            exec_cap)
    assert got.dtype == torch.int32
    assert got.shape == (A, min(exec_cap, cap))
    if mode == "ties" or exec_cap > cap:   # interpret mode is slow: two cases
        pallas = np.asarray(jes.select_events(
            jnp.asarray(tk[0]), jnp.asarray(sq[0]), exec_cap, interpret=True))
        np.testing.assert_array_equal(got[0].numpy(), pallas)
    for a in range(A):
        xla = np.asarray(jeng.select_events_xla(
            jnp.asarray(tk[a]), jnp.asarray(sq[a]), min(exec_cap, cap)))
        np.testing.assert_array_equal(got[a].numpy(), xla)


def test_sort_events_matches_pallas():
    tk, sq = _select_inputs(20, "rand", 3)
    got = ref.sort_events(torch.from_numpy(tk), torch.from_numpy(sq))
    want = np.asarray(jes.sort_events(jnp.asarray(tk[0]), jnp.asarray(sq[0]),
                                      interpret=True))
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("m,density,n_kinds", [
    (64, 0.5, 8), (100, 0.0, 8), (40, 1.0, 8), (37, 0.7, 3)])
def test_group_by_kind_matches_pallas_and_xla(m, density, n_kinds):
    rng = np.random.default_rng(m + n_kinds)
    kind = rng.integers(-2, n_kinds + 2, (A, m)).astype(np.int32)
    active = rng.random((A, m)) < density
    got = ref.group_by_kind(torch.from_numpy(kind), torch.from_numpy(active),
                            n_kinds)
    if m < 40:                             # interpret mode is slow: one case
        pallas = jes.group_by_kind(jnp.asarray(kind[0]),
                                   jnp.asarray(active[0]), n_kinds,
                                   interpret=True)
        for g, p in zip(got, pallas):
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(p))
    for g in got:
        assert g.dtype == torch.int32
    for a in range(A):
        xla = jeng.group_by_kind_xla(jnp.asarray(kind[a]),
                                     jnp.asarray(active[a]), n_kinds)
        for g, x in zip(got, xla):
            np.testing.assert_array_equal(g[a].numpy(), np.asarray(x))


@pytest.mark.parametrize("n,density", [(1, 1.0), (37, 0.4), (200, 0.9)])
def test_trace_rank_matches_pallas_and_ref(n, density):
    rng = np.random.default_rng(n)
    mask = rng.random((A, n)) < density
    got = ref.trace_rank(torch.from_numpy(mask))
    assert got.dtype == torch.int32
    for a in range(A):
        pallas = np.asarray(jes.trace_rank(jnp.asarray(mask[a]),
                                           interpret=True))
        xla = np.asarray(jref.trace_rank_ref(jnp.asarray(mask[a])))
        np.testing.assert_array_equal(got[a].numpy(), pallas)
        np.testing.assert_array_equal(got[a].numpy(), xla)


@pytest.mark.parametrize("n,n_buckets", [(64, 3), (200, 9), (256, 1)])
def test_route_rank_matches_pallas_and_xla(n, n_buckets):
    rng = np.random.default_rng(n * n_buckets)
    dst = rng.integers(0, n_buckets, (A, n)).astype(np.int32)
    got = ref.route_rank(torch.from_numpy(dst))
    assert got.dtype == torch.int32
    for a in range(A):
        pallas = np.asarray(jes.route_rank(jnp.asarray(dst[a]),
                                           interpret=True))
        xla = np.asarray(jeng.route_rank_xla(jnp.asarray(dst[a])))
        np.testing.assert_array_equal(got[a].numpy(), pallas)
        np.testing.assert_array_equal(got[a].numpy(), xla)


def test_route_rank_plain_takes_general_keys():
    """The plain version keeps route_rank_xla's semantics for any keys (the
    kernel's contract is keys in [0, n_buckets))."""
    rng = np.random.default_rng(11)
    dst = rng.integers(-50, 1 << 20, (A, 120)).astype(np.int32)
    dst[:, ::5] = 7
    got = ref.route_rank(torch.from_numpy(dst))
    for a in range(A):
        want = np.asarray(jeng.route_rank_xla(jnp.asarray(dst[a])))
        np.testing.assert_array_equal(got[a].numpy(), want)


@pytest.mark.parametrize("cap,n,head,density", [
    (16, 12, 0, 0.6), (16, 12, 13, 0.9), (37, 50, 30, 1.0), (8, 5, 7, 0.0)])
def test_ring_slots_matches_pallas_and_xla(cap, n, head, density):
    """Insert slots off a permuted ring, with heads that wrap; every row
    (the engine uses only the wanted ones) equals the reference's."""
    rng = np.random.default_rng(cap * n + head)
    ring = np.stack([rng.permutation(cap) for _ in range(A)]).astype(np.int32)
    heads = np.array([head, (head + 3) % cap], np.int32)
    want = rng.random((A, n)) < density
    got = ref.ring_slots(torch.from_numpy(ring), torch.from_numpy(heads),
                         torch.from_numpy(want))
    assert got.dtype == torch.int32 and got.shape == (A, n)
    for a in range(A):
        args = (jnp.asarray(ring[a]), jnp.asarray(heads[a]),
                jnp.asarray(want[a]))
        np.testing.assert_array_equal(got[a].numpy(),
                                      np.asarray(jref.ring_slots_ref(*args)))
        pallas = np.asarray(jops.ring_slots(*args))
        np.testing.assert_array_equal(got[a].numpy()[want[a]],
                                      pallas[want[a]])


def _fused_inputs(cap, density, tail, seed, n_tables=4, n_res=8):
    """Random (A, cap) pools for the fused front end, as
    tests/test_kernels.py makes them: time_key T_INF on unsafe slots, the
    conflict key columns pool-wide, NaN and int bit patterns in the
    payload."""
    rng = np.random.default_rng(seed)
    valid = rng.random((A, cap)) < 0.8
    safe = valid & (rng.random((A, cap)) < density)
    tk = np.where(safe, rng.integers(0, 50, (A, cap)), T_INF).astype(np.int32)
    payload = rng.standard_normal((A, cap, 8)).astype(np.float32)
    payload[:, ::5, 3] = np.float32(np.nan)
    rows = len(range(0, cap, 7))
    payload.view(np.int32)[:, ::7, 5] = rng.integers(-2**31, 2**31 - 1,
                                                     (A, rows))
    return dict(
        time_key=tk,
        seq=rng.integers(0, 2**20, (A, cap)).astype(np.int32),
        safe=safe,
        time=rng.integers(0, 50, (A, cap)).astype(np.int32),
        kind=rng.integers(0, 8, (A, cap)).astype(np.int32),
        src=rng.integers(0, 16, (A, cap)).astype(np.int32),
        dst=rng.integers(0, 16, (A, cap)).astype(np.int32),
        ctx=rng.integers(0, 100, (A, cap)).astype(np.int32),
        payload=payload, valid=valid,
        table_id=rng.integers(0, n_tables, (A, cap)).astype(np.int32),
        res=rng.integers(0, n_res, (A, cap)).astype(np.int32),
        free_tail=np.array([tail, (tail * 7 + 3) % cap], np.int32))


def _assert_fused_equal(got, want, a=None, what=""):
    """Every field byte-equal (floats by bit pattern), ``rel_pos`` where
    ``exec_safe``; ``got`` is the port's (A, m) ``FusedSelect``, ``want``
    one agent's (``a``) or the port's own."""
    es_ = np.asarray(want.exec_safe)
    for name in want._fields:
        g = getattr(got, name).numpy()
        g = g if a is None else g[a]
        w = np.asarray(getattr(want, name))
        if w.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        if name == "rel_pos":
            g, w = g[es_], w[es_]
        np.testing.assert_array_equal(g, w, err_msg=f"{what}{name}")


FUSED_KW = dict(n_kinds=8, n_res=8)
TWIN_KW = dict(FUSED_KW, n_tables=4)


def _assert_counts(counts, fs, n_kinds=8):
    """The per-kind counts of the clean lanes, counted here with numpy from
    the lanes of ``fs`` (the reference's result for one agent ``a``, or
    the port's for all)."""
    clean = np.asarray(fs.clean)
    kind = np.clip(np.asarray(fs.kind), 0, n_kinds - 1)
    want = np.stack([((kind == k) & clean).sum(-1) for k in range(n_kinds)],
                    -1).astype(np.int32)
    np.testing.assert_array_equal(counts.numpy(), want)


@pytest.mark.parametrize("cap,xcap,density,tail,seed", [
    (64, 16, 0.5, 0, 0),       # basic window
    (37, 64, 0.7, 30, 1),      # non-pow2 pool, exec_cap > pool_cap
    (256, 256, 0.9, 250, 2),   # exec_cap == pool_cap, ring cursor wraps
])
def test_fused_select_matches_ref_and_xla(cap, xcap, density, tail, seed):
    """Three of the cases of tests/test_kernels.py; the other three run in
    tests/test_torch_fused_xla.py (each compiles the reference for its
    shape, so a file holds at most 3)."""
    check_fused_xla(cap, xcap, density, tail, seed)


def check_fused_xla(cap, xcap, density, tail, seed):
    """The plain fused_select == the reference's ``fused_select_ref`` and
    its engine twin ``fused_select_xla`` on every field, per agent, with
    the per-kind counts of the reference's clean lanes; and == the port's
    stitched twin."""
    inp = _fused_inputs(cap, density, tail, seed)
    t_in = [torch.from_numpy(v) for v in inp.values()]
    got, counts = ref.fused_select(*t_in, xcap, **FUSED_KW)
    m = max(min(xcap, cap), 1)
    assert got.exec_idx.shape == (A, m) and got.payload.shape == (A, m, 8)
    twin, twin_counts = teng.fused_select_xla(*t_in, xcap, **TWIN_KW)
    _assert_fused_equal(got, twin, what="port twin: ")
    assert torch.equal(counts, twin_counts)
    for a in range(A):
        j_in = [jnp.asarray(v[a]) for v in inp.values()]
        want = jref.fused_select_ref(*j_in, xcap, **TWIN_KW)
        _assert_fused_equal(got, want, a, "ref: ")
        _assert_counts(counts[a], want)
        _assert_fused_equal(got, jeng.fused_select_xla(*j_in, xcap,
                                                       **TWIN_KW), a, "xla: ")


def test_ops_send_cpu_tensors_to_the_plain_versions():
    rng = np.random.default_rng(5)
    tk, sq = _select_inputs(40, "rand", 5)
    tk, sq = torch.from_numpy(tk), torch.from_numpy(sq)
    kind = torch.from_numpy(rng.integers(0, 8, (A, 40)).astype(np.int32))
    act = torch.from_numpy(rng.random((A, 40)) < 0.5)
    dst = torch.from_numpy(rng.integers(0, 3, (A, 40)).astype(np.int32))
    es.reset_launches()
    assert torch.equal(ops.select_events(tk, sq, 9),
                       ref.select_events(tk, sq, 9))
    assert torch.equal(ops.sort_events(tk, sq), ref.sort_events(tk, sq))
    for g, w in zip(ops.group_by_kind(kind, act, 8),
                    ref.group_by_kind(kind, act, 8)):
        assert torch.equal(g, w)
    assert torch.equal(ops.trace_rank(act), ref.trace_rank(act))
    assert torch.equal(ops.route_rank(dst, 3), ref.route_rank(dst))
    ring = torch.stack([torch.randperm(40) for _ in range(A)]).to(torch.int32)
    head = torch.tensor([3, 39], dtype=torch.int32)
    assert torch.equal(ops.ring_slots(ring, head, act),
                       ref.ring_slots(ring, head, act))
    f_in = [torch.from_numpy(v) for v in _fused_inputs(40, 0.5, 7, 5).values()]
    (got, got_counts), (want, want_counts) = (
        ops.fused_select(*f_in, 9, **FUSED_KW),
        ref.fused_select(*f_in, 9, **FUSED_KW))
    _assert_fused_equal(got, want)
    assert torch.equal(got_counts, want_counts)
    assert all(v == 0 for v in es.LAUNCHES.values())


@pytest.mark.parametrize("call", [
    lambda x: es.select_events(x, x, 4),
    lambda x: es.group_by_kind(x, x, 8),
    lambda x: es.trace_rank(x),
    lambda x: es.route_rank(x, 3),
    lambda x: es.ring_slots(x, x[:, 0], x.bool()),
    lambda x: es.fused_select(x, x, x.bool(), x, x, x, x, x,
                              torch.zeros(x.shape + (8,)), x.bool(), x, x,
                              x[:, 0], 4, n_kinds=8, n_res=4)])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    """A wrapper launches its kernel or raises: it never computes a CPU
    tensor's result itself (that is the dispatcher's plain path)."""
    x = torch.zeros((A, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        call(x)
