"""The port's core modules against the JAX reference, byte for byte.

Inputs are made with numpy from a seed and fed to both packages; every
comparison is exact, floats by bit pattern. Covered: the event pool (insert,
release, gather, compact, trace append with ring wrap and overflow drops,
the reclaims, the ring rebuild), sync, the network model in its batched and
one-lane contexts, the scenario builders, every handler kind through the
batched dispatch (delta merge), the import rule, and the device rule. The
reference insert and reclaim run in ``tests/test_torch_eager_refs.py`` and
the dense merge in ``tests/test_torch_handler_dense.py``, files of at most
3 tests, since each compares against seconds of JAX work.
"""
import ast
import dataclasses
import functools
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several worker processes on one machine: keep torch to one
# thread each, as the tensors here are small
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import components as jcomp  # noqa: E402
from repro.core import events as jev  # noqa: E402
from repro.core import handlers as jhand  # noqa: E402
from repro.core import network as jnet  # noqa: E402
from repro.core import sync as jsync  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import components as tcomp  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402
from repro_torch.core import handlers as thand  # noqa: E402
from repro_torch.core import network as tnet  # noqa: E402
from repro_torch.core import sync as tsync  # noqa: E402
from repro_torch.core.engine import Engine  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

from conftest import t0t1_builder  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def bits(x):
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.int32) if x.dtype == np.float32 else x


def assert_same(a, b, what=""):
    a, b = bits(a), bits(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def np_tree(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def t_batch(d):
    return tev.EventBatch(**{k: torch.from_numpy(np.ascontiguousarray(v))
                             for k, v in d.items()})


def rand_batch(rng, A, n, p_valid=0.7, tmax=50):
    return dict(
        time=rng.integers(0, tmax, (A, n)).astype(np.int32),
        seq=rng.integers(0, 1 << 30, (A, n)).astype(np.int32),
        kind=rng.integers(0, 8, (A, n)).astype(np.int32),
        src=rng.integers(0, 20, (A, n)).astype(np.int32),
        dst=rng.integers(0, 20, (A, n)).astype(np.int32),
        ctx=rng.integers(0, 2, (A, n)).astype(np.int32),
        payload=rng.standard_normal((A, n, 8)).astype(np.float32),
        valid=rng.random((A, n)) < p_valid)


def j_agent(d, a):
    return jev.EventBatch(**{k: jnp.asarray(v[a]) for k, v in d.items()})


# ------------------------------------------------------------------ events
def test_pool_lifecycle_matches_reference():
    """insert -> release -> insert that wraps the ring and overflows the
    pool, then gather: every field and ring cursor equal per agent."""
    rng = np.random.default_rng(0)
    A, cap = 3, 16
    pool_t = tev.empty_pool(cap, A)
    pools_j = [jev.empty_pool(cap) for _ in range(A)]
    insert_j, release_j = jax.jit(jev.insert), jax.jit(jev.release)
    for step, p_valid in enumerate((0.8, 0.5, 1.0, 0.7)):
        b = rand_batch(rng, A, 12, p_valid)
        pool_t, drop_t = tev.insert(pool_t, t_batch(b))
        for a in range(A):
            pools_j[a], drop_j = insert_j(pools_j[a], j_agent(b, a))
            assert int(drop_j) == int(drop_t[a])
        # release a random subset of live slots (distinct, currently valid)
        slots = np.zeros((A, 8), np.int32)
        mask = np.zeros((A, 8), bool)
        for a in range(A):
            live = np.flatnonzero(np.asarray(pools_j[a].valid))
            pick = rng.permutation(live)[:8]
            slots[a, :len(pick)] = pick
            mask[a, :len(pick)] = rng.random(len(pick)) < 0.8
        pool_t = tev.release(pool_t, torch.from_numpy(slots),
                             torch.from_numpy(mask))
        for a in range(A):
            pools_j[a] = release_j(pools_j[a], jnp.asarray(slots[a]),
                                   jnp.asarray(mask[a]))
        for a in range(A):
            for f, v in np_tree(pools_j[a]).items():
                assert_same(getattr(pool_t, f)[a].numpy(), v, f"{step}:{f}")
    idx = rng.integers(0, cap, (A, 7)).astype(np.int32)
    got = tev.gather(pool_t, torch.from_numpy(idx))
    for a in range(A):
        want = jev.gather(pools_j[a], jnp.asarray(idx[a]))
        for f, v in np_tree(want).items():
            assert_same(getattr(got, f)[a].numpy(), v, f)


def _random_pools(rng, A, cap, n):
    """Port and JAX pools after an insert of a random batch and a release
    of a random subset, so the ring is no longer the identity."""
    b = rand_batch(rng, A, n, 0.8)
    pool_t, _ = tev.insert(tev.empty_pool(cap, A), t_batch(b))
    slots = np.zeros((A, n // 2), np.int32)
    mask = np.zeros((A, n // 2), bool)
    for a in range(A):
        live = np.flatnonzero(np.asarray(pool_t.valid[a]))
        pick = rng.permutation(live)[:n // 2]
        slots[a, :len(pick)] = pick
        mask[a, :len(pick)] = rng.random(len(pick)) < 0.7
    pool_t = tev.release(pool_t, torch.from_numpy(slots),
                         torch.from_numpy(mask))
    pools_j = []
    for a in range(A):
        pj, _ = jev.insert(jev.empty_pool(cap), j_agent(b, a))
        pools_j.append(jev.release(pj, jnp.asarray(slots[a]),
                                   jnp.asarray(mask[a])))
    return pool_t, pools_j


def assert_pools_same(pool_t, pools_j, what):
    for a, pj in enumerate(pools_j):
        for f, v in np_tree(pj).items():
            assert_same(getattr(pool_t, f)[a].numpy(), v, f"{what}:{f}")


def test_pop_mask_extract_and_rebuild_ring_match_reference():
    rng = np.random.default_rng(22)
    A, cap = 3, 16
    pool_t, pools_j = _random_pools(rng, A, cap, 12)
    mask = rng.random((A, cap)) < 0.5
    got = tev.extract(pool_t, torch.from_numpy(mask))
    for a in range(A):
        want = jev.extract(pools_j[a], jnp.asarray(mask[a]))
        for f, v in np_tree(want).items():
            assert_same(getattr(got, f)[a].numpy(), v, f"extract:{f}")
    assert_pools_same(tev.rebuild_ring(pool_t),
                      [jev.rebuild_ring(p) for p in pools_j], "rebuild")
    assert_pools_same(tev.pop_mask(pool_t, torch.from_numpy(mask)),
                      [jev.pop_mask(p, jnp.asarray(mask[a]))
                       for a, p in enumerate(pools_j)], "pop_mask")


def test_insert_through_slot_fn_matches_reference():
    """The ring insert with the ``ring_slots`` hook (plain version here),
    from a ring whose head wraps, equals the reference's insert."""
    rng = np.random.default_rng(23)
    A, cap = 2, 16
    pool_t, pools_j = _random_pools(rng, A, cap, 14)
    for step in range(3):
        b = rand_batch(rng, A, 9, 0.8)
        pool_t, drop_t = tev.insert(pool_t, t_batch(b),
                                    slot_fn=tref.ring_slots)
        slots = np.zeros((A, 6), np.int32)
        mask = np.zeros((A, 6), bool)
        for a in range(A):
            pools_j[a], drop_j = jev.insert(pools_j[a], j_agent(b, a))
            assert int(drop_j) == int(drop_t[a])
            live = np.flatnonzero(np.asarray(pools_j[a].valid))
            pick = rng.permutation(live)[:6]
            slots[a, :len(pick)] = pick
            mask[a, :len(pick)] = True
        pool_t = tev.release(pool_t, torch.from_numpy(slots),
                             torch.from_numpy(mask))
        pools_j = [jev.release(p, jnp.asarray(slots[a]), jnp.asarray(mask[a]))
                   for a, p in enumerate(pools_j)]
        assert_pools_same(pool_t, pools_j, str(step))
    assert int(pool_t.free_head.min()) > 0   # the head moved round the ring


@pytest.mark.parametrize("n,cap", [(24, 8), (12, 30)])
def test_compact_batch_matches_reference(n, cap):
    rng = np.random.default_rng(n + cap)
    A = 2
    b = rand_batch(rng, A, n)
    got, n_valid, dropped = tev.compact_batch(t_batch(b), cap)
    for a in range(A):
        want, wv, wd = jev.compact_batch(j_agent(b, a), cap)
        assert int(wv) == int(n_valid[a]) and int(wd) == int(dropped[a])
        w = np_tree(want)
        valid = w["valid"]
        assert_same(got.valid[a].numpy(), valid, "valid")
        for f, v in w.items():
            if f == "time":   # invalid rows carry T_INF in both
                assert_same(got.time[a].numpy(), v, f)
            else:            # invalid rows carry unused filler
                assert_same(getattr(got, f)[a].numpy()[valid], v[valid], f)


@pytest.mark.parametrize("ring", [False, True])
def test_trace_append_wraps_and_drops_like_reference(ring):
    rng = np.random.default_rng(int(ring))
    A, cap, n = 2, 10, 6
    trace_t = torch.zeros((A, cap, 4), dtype=torch.int32)
    tn_t = torch.zeros((A,), dtype=torch.int32)
    trace_j = [jnp.zeros((cap, 4), jnp.int32) for _ in range(A)]
    tn_j = [jnp.int32(0) for _ in range(A)]
    for _ in range(4):     # 4 windows of up to 6 rows overflow / wrap cap 10
        rows = rng.integers(0, 1000, (A, n, 4)).astype(np.int32)
        mask = rng.random((A, n)) < 0.8
        trace_t, tn_t, clip_t = tev.trace_append(
            trace_t, tn_t, torch.from_numpy(rows), torch.from_numpy(mask),
            ring=ring)
        for a in range(A):
            trace_j[a], tn_j[a], clip_j = jev.trace_append(
                trace_j[a], tn_j[a], jnp.asarray(rows[a]),
                jnp.asarray(mask[a]), ring=ring)
            assert int(clip_j) == int(clip_t[a])
    for a in range(A):
        assert_same(trace_t[a].numpy(), trace_j[a], "trace")
        assert int(tn_t[a]) == int(tn_j[a])


def test_child_seq_wraps_like_reference():
    parents = np.array([0, 5, 2**29, 2**31 - 1, 1234567891], np.int32)
    for slot in range(4):
        assert_same(tev.child_seq(torch.from_numpy(parents), slot).numpy(),
                    jev.child_seq(jnp.asarray(parents), slot))


# -------------------------------------------------------------------- sync
def test_sync_matches_reference():
    rng = np.random.default_rng(3)
    A, cap, n_ctx = 3, 20, 3
    b = rand_batch(rng, A, cap, p_valid=0.6)
    b["ctx"] = rng.integers(0, n_ctx, (A, cap)).astype(np.int32)
    pool_t = tev.empty_pool(cap, A)
    pool_t, _ = tev.insert(pool_t, t_batch(b))
    lmin = tsync.local_min_per_ctx(pool_t, n_ctx)
    gvt = tsync.global_min(lmin)
    hor = tsync.horizons(gvt, 3, 40)
    safe = tsync.safe_mask(pool_t, hor)
    lmin_j = []
    for a in range(A):
        pj, _ = jev.insert(jev.empty_pool(cap), j_agent(b, a))
        lmin_j.append(np.asarray(jsync.local_min_per_ctx(pj, n_ctx)))
        assert_same(lmin[a].numpy(), lmin_j[a])
    gvt_j = np.min(np.stack(lmin_j), axis=0)
    hor_j = jsync.horizons(jnp.asarray(gvt_j), 3, 40)
    for a in range(A):
        assert_same(gvt[a].numpy(), gvt_j)
        assert_same(hor[a].numpy(), hor_j)
        pj, _ = jev.insert(jev.empty_pool(cap), j_agent(b, a))
        assert_same(safe[a].numpy(), jsync.safe_mask(pj, hor_j))
    for t_end in (5, 40, 2**31 - 1):
        done = tsync.all_done(gvt, t_end)
        assert bool(done[0]) == bool(jsync.all_done(jnp.asarray(gvt_j),
                                                    t_end))


def test_exec_selection_matches_reference():
    rng = np.random.default_rng(24)
    A, cap, m = 3, 40, 12
    safe = rng.random((A, cap)) < 0.6
    idx = np.stack([rng.permutation(cap)[:m] for _ in range(A)]).astype(
        np.int32)
    slot_mask, exec_safe = tsync.exec_selection(torch.from_numpy(safe),
                                                torch.from_numpy(idx))
    for a in range(A):
        sm_j, es_j = jsync.exec_selection(jnp.asarray(safe[a]),
                                          jnp.asarray(idx[a]))
        assert_same(slot_mask[a].numpy(), sm_j, "slot_mask")
        assert_same(exec_safe[a].numpy(), es_j, "exec_safe")


@pytest.mark.parametrize("seed", [0, 1])
def test_conflict_mask_matches_reference(seed):
    rng = np.random.default_rng(seed)
    A, m, n_res, n_tables = 3, 40, 6, 5
    safe = rng.random((A, m)) < 0.7
    table = rng.integers(0, n_tables, (A, m)).astype(np.int32)
    res = rng.integers(0, n_res, (A, m)).astype(np.int32)
    got = tsync.conflict_mask(torch.from_numpy(safe), torch.from_numpy(table),
                              torch.from_numpy(res), n_res=n_res,
                              n_tables=n_tables)
    for a in range(A):
        want = jsync.conflict_mask(jnp.asarray(safe[a]),
                                   jnp.asarray(table[a]),
                                   jnp.asarray(res[a]), n_res=n_res,
                                   n_tables=n_tables)
        assert_same(got[a].numpy(), want)


# ----------------------------------------------------------------- network
SWEEP_BW = (8.0, 2.0, 0.5, 0.125, 0.2, 0.0, 1.3)


def _flows(rng, B, F, L, hops):
    links = np.full((B, F, 3), -1, np.int32)
    links[:, :, :hops] = rng.integers(-1, L, (B, F, hops))
    bw = rng.choice(SWEEP_BW, (B, L)).astype(np.float32)
    active = rng.random((B, F)) < 0.7
    return links, bw, active


@pytest.mark.parametrize("F,L,hops", [(16, 4, 1), (32, 4, 3), (32, 8, 3),
                                      (8, 2, 2), (56, 8, 3), (128, 8, 3)])
def test_maxmin_rates_bit_equal(F, L, hops):
    """Max-min rates bit for bit against the vmapped reference (the
    context of the engine's handler lanes), on the simulate t0t1 sweep's
    bandwidths, the starved 0.2 case and multi-hop random routes."""
    rng = np.random.default_rng(F * L + hops)
    B = 64
    links, bw, active = _flows(rng, B, F, L, hops)
    inc_t = tnet.incidence(torch.from_numpy(links), L)
    got = tnet.maxmin_rates(inc_t, torch.from_numpy(bw),
                            torch.from_numpy(active))
    inc_j = jax.vmap(lambda x: jnet.incidence(x, L))(jnp.asarray(links))
    want = jax.jit(jax.vmap(jnet.maxmin_rates))(inc_j, jnp.asarray(bw),
                                                jnp.asarray(active))
    assert_same(inc_t.numpy(), inc_j)
    assert_same(got.numpy(), want)


def test_maxmin_rates_at_64_flows_is_a_logged_fault():
    """Bit-equal to the vmapped reference at 64 flows, the input of the
    64-flow fault once logged in ROADMAP.md (it did not reproduce: the
    port equalled the vmapped form there; the divergence was the
    reference's one-lane form, held in the tests below)."""
    rng = np.random.default_rng(64)
    B, F, L = 64, 64, 8
    links, bw, active = _flows(rng, B, F, L, 3)
    got = tnet.maxmin_rates(tnet.incidence(torch.from_numpy(links), L),
                            torch.from_numpy(bw), torch.from_numpy(active))
    inc_j = jax.vmap(lambda x: jnet.incidence(x, L))(jnp.asarray(links))
    want = np.asarray(jax.jit(jax.vmap(jnet.maxmin_rates))(
        inc_j, jnp.asarray(bw), jnp.asarray(active)))
    assert_same(got.numpy(), want)


_MAXMIN_ONE = jax.jit(jnet.maxmin_rates)


def _one_lane_ulps(F, L, lanes, seed):
    """Per lane, the port on one lane against the reference unbatched (the
    oracle's context): the largest difference in ulps, and the lanes whose
    bits differ."""
    rng = np.random.default_rng(seed)
    links, bw, active = _flows(rng, lanes, F, L, 3)
    inc_t = tnet.incidence(torch.from_numpy(links), L)
    inc_j = jax.vmap(lambda x: jnet.incidence(x, L))(jnp.asarray(links))
    worst, differ = 0, 0
    for b in range(lanes):
        got = tnet.maxmin_rates(inc_t[b:b + 1], torch.from_numpy(bw[b:b + 1]),
                                torch.from_numpy(active[b:b + 1]))[0]
        want = _MAXMIN_ONE(inc_j[b], jnp.asarray(bw[b]),
                           jnp.asarray(active[b]))
        d = np.abs(bits(got.numpy()).astype(np.int64)
                   - bits(np.asarray(want)).astype(np.int64))
        worst, differ = max(worst, int(d.max())), differ + int(d.max() > 0)
    return worst, differ


@pytest.mark.parametrize("F", [16, 49, 50, 51, 52, 56, 64, 65, 66, 67, 68,
                               72, 96, 128])
def test_maxmin_rates_one_lane_bit_equal(F):
    """On one lane the reference's unbatched matvec sums the flows in an
    order that depends on F (kernels/ref.py, ``_UNBATCHED_ORDER``); the
    port reproduces it for these F, bit for bit."""
    assert _one_lane_ulps(F, 8, 24, F) == (0, 0)


def test_maxmin_rates_one_lane_caveat_is_bounded():
    """60 flows is an F whose one-lane order is not reproduced (ROADMAP.md,
    reference caveats): the rates differ from the reference in some lanes,
    by at most 8 ulps."""
    worst, differ = _one_lane_ulps(60, 8, 24, 60)
    assert differ > 0 and worst <= 8


@pytest.mark.parametrize("n", [29, 31, 35, 37, 39, 41, 42, 43, 44, 46, 47,
                               49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59,
                               60, 61, 62, 63])
def test_maxmin_rates_one_lane_bit_equal_at_bridge_shapes(n):
    """The workload bridge's shapes, 2n flows over n links, where the
    reference's one-lane sum has a tail of interleaved lanes and trailing
    flows (kernels/ref.py, ``_UNBATCHED_ORDER``): bit for bit."""
    assert _one_lane_ulps(2 * n, n, 12, n) == (0, 0)


def test_progress_and_completion_bit_equal():
    """``rem - rate * dt`` is one fused multiply-add in the reference."""
    rng = np.random.default_rng(9)
    B, F = 256, 32
    rem = (rng.random((B, F)) * 100).astype(np.float32)
    rate = (rng.random((B, F)) * 3).astype(np.float32)
    rate[:, ::7] = 0.0
    tlast = rng.integers(0, 1000, (B, F)).astype(np.int32)
    active = rng.random((B, F)) < 0.8
    now = rng.integers(500, 2000, (B,)).astype(np.int32)
    t = [torch.from_numpy(x) for x in (rem, rate, tlast, active, now)]
    rem2, tl2 = tnet.progress_flows(*t)
    jr, jt = jax.jit(jax.vmap(jnet.progress_flows))(
        *(jnp.asarray(x) for x in (rem, rate, tlast, active, now)))
    assert_same(rem2.numpy(), jr)
    assert_same(tl2.numpy(), jt)
    fin = tnet.completion_times(rem2, t[1], tl2, t[3])
    fin_j = jax.jit(jax.vmap(jnet.completion_times))(jr, jnp.asarray(rate),
                                                     jt, jnp.asarray(active))
    assert_same(fin.numpy(), fin_j)


# ------------------------------------------------------------------ builder
def quickstart_model(c):
    """examples/quickstart.py's model through a components module."""
    b = c.ScenarioBuilder(max_cpu=4, queue_cap=16, max_link=4, max_flow=32)
    b.add_regional_center(n_cpu=2, cpu_power=10.0, disk=1000.0,
                          tape=10000.0, tape_rate=5.0)
    tier1 = b.add_regional_center(n_cpu=2, cpu_power=8.0, disk=500.0,
                                  tape=5000.0, tape_rate=5.0)
    wan = b.add_net_region(link_bws=[1.0, 1.0], link_lats=[5, 5])
    b.add_generator(
        target_lp=wan, kind=c.FLOW_START,
        payload=c.FLOW_START.pack(size=40.0, l0=0, notify_lp=tier1["farm"],
                                  notify_kind=c.JOB_SUBMIT.id,
                                  notify2_lp=tier1["storage"],
                                  notify2_kind=c.DATA_WRITE.id),
        interval=20, count=16)
    return b


def t0t1_torch_builder(**kw):
    """tests/conftest.py's t0t1_builder through the port's builder."""
    c = tcomp
    b = c.ScenarioBuilder(max_cpu=4, queue_cap=8, max_link=4, max_flow=16)
    c_kw = dict(wan_bw=2.0, n_flows=12, interval=25, flow_mb=40.0)
    c_kw.update(kw)
    b.add_regional_center(n_cpu=2, cpu_power=10.0, disk=500.0, tape=5000.0,
                          tape_rate=5.0)
    t1 = b.add_regional_center(n_cpu=2, cpu_power=8.0, disk=300.0,
                               tape=3000.0, tape_rate=5.0)
    wan = b.add_net_region(link_bws=[c_kw["wan_bw"]] * 2, link_lats=[5, 5])
    b.add_generator(
        target_lp=wan, kind=c.FLOW_START,
        payload=c.FLOW_START.pack(size=c_kw["flow_mb"], l0=0,
                                  notify_lp=t1["farm"],
                                  notify_kind=c.JOB_SUBMIT.id,
                                  notify2_lp=t1["storage"],
                                  notify2_kind=c.DATA_WRITE.id),
        interval=c_kw["interval"], count=c_kw["n_flows"], start=0)
    return b


def _assert_builds_equal(tb, jb, **kw):
    tw, to, te, ts = tb.build(**kw)
    jw, jo, je, js = jb.build(**kw)
    for name, t, j in (("world", tw, jw), ("own", to, jo),
                       ("init", te, je)):
        for f, v in np_tree(j).items():
            assert_same(getattr(t, f).numpy(), v, f"{name}.{f}")
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)


@pytest.mark.parametrize("model", ["t0t1", "quickstart"])
def test_builders_make_the_same_scenario(model):
    if model == "t0t1":
        jb, kw = t0t1_builder()
        _assert_builds_equal(t0t1_torch_builder(), jb, n_agents=1, **kw)
    else:
        _assert_builds_equal(quickstart_model(tcomp), quickstart_model(jcomp),
                             n_agents=4, lookahead=2, t_end=20_000,
                             pool_cap=512, work_per_mb=2.0)


def test_payload_int_fields_are_bit_exact():
    """An int32 payload field rides in a float32 lane as its raw bits."""
    spec = tcomp.PayloadSpec("size", ("token", 0, torch.int32))
    row = spec.pack(size=2.5, token=2**31 - 5)
    jspec = jcomp.PayloadSpec("size", ("token", 0, jnp.int32))
    assert_same(row, jspec.pack(size=2.5, token=2**31 - 5))
    p = torch.from_numpy(np.stack([row, row]))
    assert spec.get(p, "token").tolist() == [2**31 - 5] * 2
    assert spec.get(p, "size").tolist() == [2.5, 2.5]


# ----------------------------------------------------------------- handlers
def _handler_world(c):
    """Four rows of every component, so a lane batch can address distinct
    rows of one table."""
    b = c.ScenarioBuilder(max_cpu=4, queue_cap=4, max_link=4, max_flow=8)
    lps = dict(farm=[], net=[], sto=[], gen=[])
    for i in range(4):
        lps["farm"].append(b.add_farm([10.0, 8.0, 0.0, 3.0 + i]))
        lps["net"].append(b.add_net_region([2.0, 0.5, 0.125, 0.0],
                                           [5, 5, 8, 1]))
        lps["sto"].append(b.add_storage(100.0 + i, 1000.0, 5.0))
        lps["gen"].append(b.add_generator(
            target_lp=0, kind=c.FLOW_START,
            payload=c.FLOW_START.pack(size=20.0, l0=0, notify_lp=1,
                                      notify_kind=c.JOB_SUBMIT.id),
            interval=3 + i, count=i))
    return b, lps


def _randomize(world, rng, n_lp):
    """Reachable-looking mutable state: busy CPUs, queued jobs, live flows."""
    w = dict(world)
    shape = w["cpu_busy"].shape
    w["cpu_busy"] = (rng.random(shape) < 0.6).astype(np.int32)
    w["cpu_mem"] = rng.random(shape).astype(np.float32)
    jq = (rng.random(w["jobq"].shape) * 50).astype(np.float32)
    jq[..., 2] = rng.integers(-1, n_lp, jq.shape[:-1])
    jq[..., 3] = rng.integers(0, 8, jq.shape[:-1])
    w["jobq"] = jq
    w["jobq_n"] = rng.integers(0, jq.shape[1] + 1, shape[0]).astype(np.int32)
    fshape = w["flow_active"].shape
    w["flow_active"] = rng.random(fshape) < 0.5
    w["flow_rem"] = (rng.random(fshape) * 30).astype(np.float32)
    w["flow_rem"][rng.random(fshape) < 0.3] = 0.0
    w["flow_rate"] = (rng.random(fshape) * 2).astype(np.float32)
    w["flow_tlast"] = rng.integers(0, 50, fshape).astype(np.int32)
    w["flow_links"] = rng.integers(-1, 4, fshape + (3,)).astype(np.int32)
    fn = (rng.random(fshape + (6,)) * 40).astype(np.float32)
    fn[..., 0] = rng.integers(-1, n_lp, fshape)
    fn[..., 1] = rng.integers(0, 8, fshape)
    w["flow_notify"] = fn
    w["net_gen"] = rng.integers(0, 5, fshape[0]).astype(np.int32)
    w["sto_used"] = (rng.random(w["sto_used"].shape) * 120).astype(np.float32)
    w["sto_flag"] = rng.integers(0, 2, w["sto_flag"].shape).astype(np.int32)
    w["gen_left"] = rng.integers(0, 3, w["gen_left"].shape).astype(np.int32)
    return w


def _kind_payload(rng, kind, n, world, res, n_lp):
    p = (rng.random((n, 8)) * 30).astype(np.float32)
    if kind == tcomp.K_FLOW_START:
        p[:, 1:4] = rng.integers(-1, 4, (n, 3))
        p[:, 4] = rng.integers(-1, n_lp, n)
        p[:, 5] = rng.integers(0, 8, n)
        p[:, 6] = rng.integers(-1, n_lp, n)
    elif kind == tcomp.K_FLOW_END:
        live = rng.random(n) < 0.7
        p[:, 0] = np.where(live, world["net_gen"][res], 99)
    elif kind == tcomp.K_JOB_SUBMIT:
        p[:, 2] = rng.integers(-1, n_lp, n)
        p[:, 3] = rng.integers(0, 8, n)
    elif kind == tcomp.K_JOB_END:
        p[:, 0] = rng.integers(0, 4, n)
        p[:, 3] = rng.integers(-1, n_lp, n)
        p[:, 4] = rng.integers(0, 8, n)
    return p


N_LANES = 8
_RUN_J = jax.jit(functools.partial(jhand.apply_handler_batch,
                                   jcomp.BUILTIN.make_handlers(2, 2.0)))
KIND_TABLE_NAME = {tcomp.K_FLOW_START: "net", tcomp.K_FLOW_END: "net",
                   tcomp.K_JOB_SUBMIT: "farm", tcomp.K_JOB_END: "farm",
                   tcomp.K_DATA_WRITE: "sto", tcomp.K_MIGRATE: "sto",
                   tcomp.K_GEN_TICK: "gen", tcomp.K_NOOP: "gen"}


@pytest.mark.parametrize("kind", list(range(tcomp.N_KINDS)) + ["mixed"])
def test_apply_handler_batch_matches_reference(kind):
    """One batched dispatch of random events (distinct rows per table, some
    lanes inactive): the world, the counter delta and the valid emits."""
    _check_batch(kind, _RUN_J, thand.apply_handler_batch)


def _check_batch(kind, run_j, run_t):
    nan = kind == "nan"
    kind = tcomp.K_FLOW_START if nan else kind
    rng = np.random.default_rng(7 if kind == "mixed" else kind)
    jb, lps = _handler_world(jcomp)
    jw, jo, je, js = jb.build(n_agents=1, lookahead=2, t_end=1000,
                              work_per_mb=2.0)
    n_lp = js.n_lp
    world = _randomize(np_tree(jw), rng, n_lp)
    if nan:
        for f in ("sto_used", "flow_rem", "flow_rate"):
            x = world[f].reshape(-1)
            x[rng.permutation(x.size)[:max(x.size // 4, 1)]] = np.nan
    kinds = (rng.permutation(np.arange(tcomp.N_KINDS)) if kind == "mixed"
             else np.full(N_LANES, kind))
    used = {t: iter(rng.permutation(4)) for t in lps}
    dst, res, kinds_used = [], [], []
    for k in kinds:
        t = KIND_TABLE_NAME[int(k)]
        r = next(used[t], None)
        if r is None:         # a table's rows are used up: a NOOP lane
            k, t, r = tcomp.K_NOOP, "gen", 0
        kinds_used.append(int(k))
        dst.append(lps[t][r])
        res.append(r)
    n = N_LANES
    kinds = np.asarray(kinds_used, np.int32)
    payload = np.concatenate([
        _kind_payload(rng, int(k), 1, world, np.asarray([r]), n_lp)
        for k, r in zip(kinds, res)])
    rows = dict(time=rng.integers(40, 60, n).astype(np.int32),
                seq=rng.integers(0, 1 << 30, n).astype(np.int32),
                kind=kinds, src=rng.integers(0, n_lp, n).astype(np.int32),
                dst=np.asarray(dst, np.int32),
                ctx=np.zeros(n, np.int32), payload=payload,
                valid=np.ones(n, bool))
    active = rng.random(n) < 0.85

    jworld = jw.__class__(**{k: jnp.asarray(v) for k, v in world.items()})
    w_j, c_j, out_j = run_j(jworld, jev.EventBatch(
        **{k: jnp.asarray(v) for k, v in rows.items()}), jnp.asarray(active))

    tw = tcomp.World(**{k: torch.from_numpy(np.array(v))[None]
                        for k, v in world.items()})
    table_t = tcomp.BUILTIN.make_handlers(2, 2.0)
    w_t, c_t, out_t = run_t(
        table_t, tw, t_batch({k: v[None] for k, v in rows.items()}),
        torch.from_numpy(active)[None])
    for f, v in np_tree(w_j).items():
        assert_same(getattr(w_t, f)[0].numpy(), v, f)
    assert_same(c_t[0].numpy(), c_j, "counters")
    oj = np_tree(out_j)
    valid = oj["valid"]
    assert_same(out_t.valid[0].numpy(), valid, "emit valid")
    for f, v in oj.items():
        assert_same(getattr(out_t, f)[0].numpy()[valid], v[valid], f"emit {f}")


# ------------------------------------------------------- package boundaries
def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_engine_and_launcher_need_a_card_unless_told(monkeypatch):
    from repro_torch.launch import simulate
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w, o, e, s = t0t1_torch_builder().build(n_agents=1, lookahead=2,
                                            t_end=5000, pool_cap=256)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(w, o, e, s)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate.main(["t0t1", "--bandwidths", "8.0"])
    Engine(w, o, e, s, device="cpu")    # the CPU only when asked


@pytest.mark.parametrize("opt,match", [
    (dict(fused_select=1), "fused_select must be a bool"),
    (dict(merge_mode="x"), "merge_mode must be"),
    (dict(insert_mode="x"), "insert_mode must be")])
def test_unported_options_raise(opt, match):
    """Every window option now runs; unknown values raise, as in the
    reference."""
    w, o, e, s = t0t1_torch_builder().build(n_agents=1, lookahead=2,
                                            t_end=5000, pool_cap=256)
    s = dataclasses.replace(s, **opt)
    with pytest.raises(ValueError, match=match):
        Engine(w, o, e, s, device="cpu")


def test_state_round_trips_through_numpy():
    w, o, e, s = t0t1_torch_builder().build(n_agents=2, lookahead=2,
                                            t_end=5000, pool_cap=64)
    eng = Engine(w, o, e, s, trace_cap=32, device="cpu")
    st = eng.step_local(eng.step_local(eng.init_state()))
    d = convert.state_to_numpy(st)
    d2 = convert.state_to_numpy(convert.state_from_numpy(d))
    for part in ("world", "pool"):
        for k, v in d[part].items():
            assert_same(d2[part][k], v, k)
    for k in ("counters", "trace", "trace_n", "windows", "done"):
        assert_same(d2[k], d[k], k)
