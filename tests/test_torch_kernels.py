"""The port's window front-end kernels, plain versions against the reference.

Each plain PyTorch version in ``repro_torch.kernels.ref`` is held byte for
byte against the JAX Pallas kernel run with ``interpret=True`` (as
tests/test_kernels.py runs it) and against its XLA twin, on seeded numpy
inputs: ties, all-unsafe pools, caps that are not powers of two and
``exec_cap > cap``. The CUDA kernels themselves need the card; chip_smoke.py
holds them against these plain versions there.
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
from repro.kernels import ref as jref  # noqa: E402
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
    assert all(v == 0 for v in es.LAUNCHES.values())


@pytest.mark.parametrize("call", [
    lambda x: es.select_events(x, x, 4),
    lambda x: es.group_by_kind(x, x, 8),
    lambda x: es.trace_rank(x),
    lambda x: es.route_rank(x, 3)])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    """A wrapper launches its kernel or raises: it never computes a CPU
    tensor's result itself (that is the dispatcher's plain path)."""
    x = torch.zeros((A, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        call(x)
