"""The port's placement layer against the reference's: the scheduler bit
for bit, the context helpers, and ``apply_placement_local`` byte for byte.

The scheduler's functions run on seeded counters at 1, 2, 3, 8 and 16
agents (some fleets all alike, so the argmin ties): performance values,
graph, shortest paths and scores compared by bit pattern, ``choose_agent``,
``plan_placement`` and ``rebalance`` placements equal. Migration runs the
T0/T1 model at 4 agents for a few windows, moves every LP one agent on,
and continues to the end through both packages: the migrated and the final
states byte-equal, the migrate books balanced and nonzero, the merged trace
equal to the port's oracle. Then the reference's idle-LP scenario: a
receiver's overflow booked as ``C_DROP_POOL``, an identity placement moving
nothing, and a migrated state through a checkpoint and back.

The JAX engine compiles its window and each placement (about 15 s in all),
so this file holds two tests and queues behind the three-test files (see
test_torch_engine.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several worker processes on one machine: keep torch to one
# thread each, as the tensors here are small
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import Engine as JEngine  # noqa: E402
from repro.core import ScenarioBuilder as JBuilder  # noqa: E402
from repro.core import context as jctx  # noqa: E402
from repro.core import events as jev  # noqa: E402
from repro.core import scheduler as jsch  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import SimCheckpointer  # noqa: E402
from repro_torch.core import Engine, merged_engine_trace  # noqa: E402
from repro_torch.core import context as tctx  # noqa: E402
from repro_torch.core import monitoring as tmon  # noqa: E402
from repro_torch.core import run_sequential  # noqa: E402
from repro_torch.core import scheduler as tsch  # noqa: E402

from conftest import t0t1_builder  # noqa: E402
from test_torch_engine import (assert_states_equal, np_tree,  # noqa: E402
                               port_scenario)

STATE_LEAVES = ("counters", "t_now", "done", "windows", "trace", "trace_n",
                "trace_tail")


def jax_state(st):
    jax.block_until_ready(st.counters)
    return {"world": np_tree(st.world), "pool": np_tree(st.pool),
            **{k: np.asarray(getattr(st, k)) for k in STATE_LEAVES}}


def bits_equal(j, t, what):
    assert_states_equal(t.numpy(), np.asarray(j), what)


def t_(x):
    return torch.from_numpy(np.asarray(x))


def test_scheduler_and_contexts_equal_jax():
    rng = np.random.default_rng(7)
    for A in (1, 2, 3, 8, 16):
        for trial in range(3):
            c = rng.integers(0, 5000, (A, tmon.N_COUNTERS)).astype(np.int32)
            c[:, tmon.C_WINDOWS] = rng.integers(0, 300, A)
            if trial % 3 == 0:
                c[:] = c[0]                  # a fleet all alike: ties
            la = rng.integers(0, A, 40).astype(np.int32)
            ctx = rng.integers(0, 3, 40).astype(np.int32)
            occ = rng.integers(0, 100, A).astype(np.int32)
            if trial % 3 == 0:
                la[:] = np.arange(40) % A
                occ[:] = occ[0]
            owned = np.bincount(la, minlength=A).astype(np.int32)
            what = f"A={A} trial {trial}"
            pj = jsch.perf_values_from_counters(jnp.asarray(c),
                                                jnp.asarray(owned),
                                                jnp.asarray(occ))
            pt = tsch.perf_values_from_counters(t_(c), t_(owned), t_(occ))
            bits_equal(pj, pt, f"perf {what}")
            gj, gt = jsch.performance_graph(pj), tsch.performance_graph(pt)
            bits_equal(gj, gt, f"graph {what}")
            link = rng.uniform(0, 3, (A, A)).astype(np.float32)
            bits_equal(jsch.performance_graph(pj, jnp.asarray(link)),
                       tsch.performance_graph(pt, t_(link)),
                       f"graph + links {what}")
            dj, dt = jsch.apsp(gj), tsch.apsp(gt)
            bits_equal(dj, dt, f"apsp {what}")
            for part in (np.zeros(A, bool), rng.integers(0, 2, A) > 0,
                         np.ones(A, bool)):
                bits_equal(jsch.placement_scores(dj, jnp.asarray(part), pj),
                           tsch.placement_scores(dt, t_(part), pt),
                           f"scores {what}")
                bits_equal(jsch.choose_agent(pj, jnp.asarray(part)),
                           tsch.choose_agent(pt, t_(part)),
                           f"choose {what}")
            bits_equal(jsch.plan_placement(pj, jnp.asarray(ctx), A),
                       tsch.plan_placement(pt, t_(ctx), A), f"plan {what}")
            for thr in (1.05,) if trial else (1.05, 2.0):
                bits_equal(jsch.rebalance(jnp.asarray(c), jnp.asarray(la),
                                          jnp.asarray(ctx), jnp.asarray(occ),
                                          threshold=thr),
                           tsch.rebalance(t_(c), t_(la), t_(ctx), t_(occ),
                                          threshold=thr),
                           f"rebalance {thr} {what}")

    # the context helpers on a mid-run T0/T1 state
    b, kw = t0t1_builder()
    built = b.build(n_agents=2, n_ctx=1, **kw)
    scen = port_scenario(*built)
    st = Engine(*scen, trace_cap=64, device="cpu").run_local(max_windows=5)
    pool = st.pool
    pool = pool._replace(ctx=torch.where(pool.valid, pool.seq % 3, 0))
    jpool = jev.EventPool(**{k: jnp.asarray(v.numpy())
                             for k, v in pool._asdict().items()})
    bits_equal(jax.vmap(lambda p: jctx.ctx_event_counts(p, 3))(jpool),
               tctx.ctx_event_counts(pool, 3), "ctx_event_counts")
    bits_equal(jctx.ctx_lp_counts(built[0], 2),
               tctx.ctx_lp_counts(scen[0], 2), "ctx_lp_counts")
    gvt = np.array([0, 4999, 5000, jev.T_INF], np.int32)
    bits_equal(jctx.ctx_done(jnp.asarray(gvt), 5000),
               tctx.ctx_done(t_(gvt), 5000), "ctx_done")
    assert tctx.validate_isolation(scen[0]) == \
        jctx.validate_isolation(built[0]) is True
    assert tctx.validate_isolation(st.world)


def idle_scenario(n_idle=12, n_agents=3, pool_cap=8):
    """The reference's test_migration scenario: bare LPs round-robined over
    the agents, one pending NOOP each past t_end, freight for a migration."""
    b = JBuilder()
    lps = [b.add_idle_lp() for _ in range(n_idle)]
    for i, lp in enumerate(lps):
        b.add_event(time=50 + i, kind=jev.K_NOOP, src=lp, dst=lp)
    return b.build(n_agents=n_agents, lookahead=1, t_end=10,
                   pool_cap=pool_cap)


def migrate_both(built, new_la, jst=None, tst=None):
    """``apply_placement_local`` through both packages (from their initial
    states unless given): the two results byte-equal. Returns them."""
    jeng = JEngine(*built)
    teng = Engine(*port_scenario(*built), device="cpu")
    jst = jeng.init_state() if jst is None else jst
    tst = teng.init_state() if tst is None else tst
    jout = jeng.apply_placement_local(jst, jnp.asarray(new_la))
    tout = teng.apply_placement_local(tst, torch.from_numpy(new_la))
    assert_states_equal(convert.state_to_numpy(tout), jax_state(jout))
    return teng, tout


def books(st):
    c = st.counters.numpy()
    return (c[:, tmon.C_MIGRATE_OUT], c[:, tmon.C_MIGRATE_IN],
            c[:, tmon.C_DROP_POOL])


def test_apply_placement_equals_jax(tmp_path):
    # mid-run on the T0/T1 model, then on to the end
    b, kw = t0t1_builder(n_flows=24)
    built = b.build(n_agents=4, **kw)
    scen = port_scenario(*built)
    jeng = JEngine(*built, trace_cap=512)
    teng = Engine(*scen, trace_cap=512, device="cpu")
    jst, tst = jeng.init_state(), teng.init_state()
    for _ in range(12):
        jst = jeng.step_local(jst)
    tst = teng.run_local(max_windows=12)
    assert_states_equal(convert.state_to_numpy(tst), jax_state(jst))
    la = np.asarray(jst.world.lp_agent[0])
    new_la = ((la + 1) % 4).astype(np.int32)
    jst = jeng.apply_placement_local(jst, jnp.asarray(new_la))
    tst = teng.apply_placement_local(tst, torch.from_numpy(new_la))
    assert_states_equal(convert.state_to_numpy(tst), jax_state(jst))
    out, inn, drop = books(tst)
    assert out.sum() == inn.sum() > 0 and drop.sum() == 0
    while not bool(np.asarray(jst.done)[0]):
        jst = jeng.step_local(jst)
    tst = teng.run_local(state=tst)
    tstate = convert.state_to_numpy(tst)
    assert_states_equal(tstate, jax_state(jst))
    assert merged_engine_trace(tstate["trace"], tstate["trace_n"]) == \
        run_sequential(*scen)[2]

    # a receiver that cannot hold the freight: the excess in C_DROP_POOL on
    # the receiver, the books balanced
    built = idle_scenario()
    _, tout = migrate_both(built, np.zeros(12, np.int32))
    out, inn, drop = books(tout)
    assert out.sum() == inn.sum() == 8
    assert drop[0] == 4 and drop[1:].sum() == 0
    assert int(tout.pool.valid[0].sum()) == 8

    # an identity placement moves nothing
    teng, tst = migrate_both(built, np.arange(12, dtype=np.int32) % 3)
    out, inn, drop = books(tst)
    assert out.sum() == inn.sum() == drop.sum() == 0

    # a migrated state through a checkpoint and back
    la = np.arange(12) % 3
    new_la = np.where(la == 2, 0, la).astype(np.int32)
    teng, tout = migrate_both(built, new_la)
    ck = SimCheckpointer(str(tmp_path))
    ck.save_sim(0, tout, engine=teng)
    teng2 = Engine(*port_scenario(*built), device="cpu",
                   checkpointer=SimCheckpointer(str(tmp_path)))
    rec = teng2.restore()
    assert_states_equal(convert.state_to_numpy(rec.state),
                        convert.state_to_numpy(tout))
    out, inn, _ = books(rec.state)
    assert out.sum() == inn.sum() == 4
