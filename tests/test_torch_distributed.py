"""The port's drivers across devices on their own, with no JAX.

``Engine.run_distributed`` over D CPU shards equals ``run_local`` in full
state, pool slot layouts included, and its merged trace equals the oracle's,
at agent counts that pack evenly and unevenly (pad agents), on both front
ends, the reference insert and the dense merge, and on one shard. The pad
agents stay inert; the three collectives equal their one-device versions;
the migration across shards equals ``apply_placement_local``; the adaptive
driver's rungs follow ``run_adaptive``'s; and a streamed, checkpointed run
resumes on another shard count.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several worker processes on one machine: keep torch to one
# thread each, as the tensors here are small
torch.set_num_threads(1)

from repro_torch.checkpoint import SimCheckpointer  # noqa: E402
from repro_torch.core import (Engine, MetricsStream, TraceStream,  # noqa: E402
                              merged_engine_trace, run_sequential, sync)
from repro_torch.core import monitoring as mon  # noqa: E402
from repro_torch.core import shards as sh  # noqa: E402
from repro_torch.core import tensor_util as tu  # noqa: E402
from repro_torch.core.policy import ExecPolicy  # noqa: E402
from repro_torch.launch import simulate  # noqa: E402
from repro_torch.launch.mesh import make_sim_mesh  # noqa: E402

from test_torch_ensemble_port import assert_same, np_state  # noqa: E402


def build(n_agents, flows=12, **kw):
    kw.setdefault("exec_cap", 16)
    return simulate.t0t1_scenario(2.0, flows, n_agents, **kw)


def engine(built, **kw):
    return Engine(*built, device="cpu", trace_cap=kw.pop("trace_cap", 256),
                  **kw)


def merged(st):
    return merged_engine_trace(st.trace.numpy(), st.trace_n.numpy())


@pytest.fixture(scope="module")
def oracle():
    return run_sequential(*build(1))[2]


@pytest.mark.parametrize("n_agents,n_shards,opts", [
    (3, 2, {}), (4, 2, {}), (6, 4, {}), (7, 3, {}), (4, 1, {}),
    (4, 4, {}), (7, 2, dict(fused_select=True)),
    (3, 2, dict(fused_select=True)),
    (6, 4, dict(insert_mode="ref", merge_mode="dense")),
])
def test_run_distributed_equals_run_local_and_oracle(n_agents, n_shards, opts,
                                                     oracle):
    built = build(n_agents, **opts)
    want = engine(built).run_local()
    eng = engine(built)
    got = eng.run_distributed(make_sim_mesh(n_shards, "cpu"))
    assert_same(np_state(got), np_state(want), f"{n_agents} on {n_shards}")
    assert merged(got) == oracle
    assert int(got.counters[:, mon.C_MSGS_REMOTE].sum()) > 0
    # two host reads a window for any shard count: `done`, and the
    # fallback's counts of every shard in one read
    assert eng.host_reads == 2 * int(got.windows[0]) + 2


def test_pad_agents_stay_inert():
    """Three agents on two shards: the fourth row is a pad agent. Stepped
    window by window, the real rows equal ``run_local``'s, and the pad row
    holds no event, writes no trace, counts nothing but windows and its
    gauges, and keeps the fleet's world."""
    built = build(3)
    eng = engine(built)
    axes = eng._dist_axes(["cpu"] * 2)
    assert (axes.n_shards, axes.n_lanes, axes.size) == (2, 2, 4)
    shards = eng._split(eng._pad_state(eng.init_state(), 4), axes)
    st_local = eng.init_state()
    for _ in range(40):
        shards = eng._step(shards, axes)
        st_local = eng.step_local(st_local)
    st = eng._join(shards)
    assert_same(np_state(eng._slice_state(st)), np_state(st_local))
    assert not st.pool.valid[3].any()
    assert int(st.pool.free_count[3]) == built[3].pool_cap
    assert int(st.trace_n[3]) == 0
    idle = [i for i in range(st.counters.shape[1])
            if i not in (mon.C_WINDOWS, mon.C_POOL_FREE)]
    assert not st.counters[3, idle].any()
    assert int(st.counters[3, mon.C_WINDOWS]) == 40
    for name, x in st.world._asdict().items():
        assert torch.equal(x[3], x[0]), name
    assert torch.equal(st.t_now[3], st.t_now[0])


def test_collectives_equal_one_device_versions():
    g = torch.Generator().manual_seed(0)
    D, K = 3, 2
    n = D * K
    axes = sh.ShardAxes(("cpu",) * D, K)
    one = sh.ShardAxes(("cpu",), n)
    x = torch.randint(0, 1000, (n, 5), generator=g, dtype=torch.int32)
    parts = lambda t: list(t.split(K))   # noqa: E731
    for got, want in zip(axes.global_min(parts(x)),
                         parts(sync.global_min(x))):
        assert torch.equal(got, want)
    # owner-wins: one nonzero term an element
    owner = torch.randint(0, n, (7,), generator=g)
    vals = torch.randn(n, 7, generator=g)
    f = torch.where(owner[None] == torch.arange(n)[:, None], vals, 0.0)
    i = torch.where(owner[None] == torch.arange(n)[:, None],
                    torch.randint(-9, 9, (n, 7), generator=g,
                                  dtype=torch.int32), 0)
    got = axes.owner_sum([[a, b] for a, b in zip(parts(f), parts(i))])
    for s, (gf, gi) in enumerate(got):
        assert torch.equal(gf, tu.group_sum(f)[s * K:(s + 1) * K])
        assert torch.equal(gi, tu.group_sum(i)[s * K:(s + 1) * K])
    # the exchange: the one-device transpose of the stacked send buffers
    rcap = 3
    bufs = [torch.randint(0, 99, (n, n * rcap), generator=g,
                          dtype=torch.int32),
            torch.randn(n, n * rcap, 4, generator=g),
            torch.rand(n, n * rcap, generator=g) > 0.5]
    want = one.exchange([bufs], rcap)[0]
    got = axes.exchange([[b[s * K:(s + 1) * K] for b in bufs]
                         for s in range(D)], rcap)
    for c in range(3):
        assert torch.equal(torch.cat([got[s][c] for s in range(D)]), want[c])
    rx = want[0].reshape(n, n, rcap)
    assert torch.equal(rx[4, 1], bufs[0].reshape(n, n, rcap)[1, 4])
    # one host read for every shard
    reads = []

    def read(t):
        reads.append(t)
        return t.numpy()
    out = axes.read(parts(x), read)
    assert len(reads) == 1
    np.testing.assert_array_equal(np.concatenate(out), x.numpy())
    assert [int(axes.me(s)[0]) for s in range(D)] == [0, 2, 4]


def test_migration_equals_local_and_balances(oracle):
    built = build(4)
    eng = engine(built)
    mid = eng.run_local(max_windows=20)
    la = mid.world.lp_agent[0].numpy()
    new_la = ((la + 1) % 4).astype(np.int32)
    want = eng.apply_placement_local(mid, new_la)
    out = int(want.counters[:, mon.C_MIGRATE_OUT].sum())
    assert out > 0 and out == int(want.counters[:, mon.C_MIGRATE_IN].sum())
    for D in (2, 3):
        got = eng.apply_placement_distributed(mid, new_la, ["cpu"] * D)
        assert_same(np_state(got), np_state(want), f"migrated on {D}")
    end = eng.run_distributed(["cpu"] * 3, state=want)
    assert_same(np_state(end), np_state(eng.run_local(state=want)))
    assert merged(end) == oracle


def test_adaptive_rungs_in_lockstep():
    built = build(5, exec_cap=None,
                  exec_policy=ExecPolicy(ladder=(1, 4, 16), init_rung=2))
    eng = engine(built)
    want = eng.run_adaptive()
    rungs = eng.adaptive_rungs
    assert len(set(rungs)) > 1
    for D in (2, 3):
        got = eng.run_distributed_adaptive(["cpu"] * D)
        assert eng.adaptive_rungs == rungs
        assert_same(np_state(got), np_state(want), f"adaptive on {D}")


def test_streamed_checkpointed_run_resumes_on_another_shard_count(
        oracle, tmp_path):
    built = build(4)
    whole_ms = MetricsStream(interval=8)
    whole = engine(built, trace_cap=32, trace_stream=TraceStream(),
                   metrics_stream=whole_ms, drain_every=4).run_local()

    class Die(RuntimeError):
        pass

    def die(window, st):
        assert st.t_now.shape == (4,)        # the unpadded state
        if window >= 20:
            raise Die

    ck = SimCheckpointer(str(tmp_path), every=8)
    with pytest.raises(Die):
        engine(built, trace_cap=32, trace_stream=TraceStream(),
               metrics_stream=MetricsStream(interval=8), drain_every=4,
               checkpointer=ck, window_hook=die).run_distributed(
            ["cpu"] * 3)
    assert ck.latest_step() == 16
    for resume_on in (["cpu"] * 2, None):
        ts, ms = TraceStream(), MetricsStream(interval=8)
        eng = engine(built, trace_cap=32, trace_stream=ts, metrics_stream=ms,
                     drain_every=4,
                     checkpointer=SimCheckpointer(str(tmp_path)))
        rec = eng.restore()
        got = (eng.run_local(state=rec.state) if resume_on is None else
               eng.run_distributed(resume_on, state=rec.state))
        assert_same(np_state(got), np_state(whole), f"resumed on {resume_on}")
        assert ts.merged() == oracle
        assert ms.lines == whole_ms.lines
        assert int(got.counters[:, mon.C_TRACE_DROP].sum()) == 0
