"""The port's replica-cache model (``repro_torch.scenarios.cache``) against
the reference's, byte for byte: the built scenario, each handler lane-wise
against the reference's vmapped handler, ``run_local`` on the stitched and
the fused front end at one and two agents (the two-agent run is the
owner-wins sync of the cache rows) and the oracle, then the same-row
serialisation through the conflict fallback and a 31-bit int payload
through the engines and the oracle.

The runs compile JAX engine code (about 12 s a configuration), so this
file holds two tests: the tier-1 run's xdist ``loadfile`` hands out files
with the most tests first, so these queue after the three-test files (see
test_torch_engine.py). ``tests/test_torch_failures.py`` uses the helpers
here for the failure model.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several worker processes on one machine: keep torch to one
# thread each, as the tensors here are small
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import Engine as JEngine  # noqa: E402
from repro.core import events as jev  # noqa: E402
from repro.core import monitoring as jmon  # noqa: E402
from repro.core import run_sequential as j_run_sequential  # noqa: E402
from repro.scenarios import cache as jcache  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import Engine, merged_engine_trace  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402
from repro_torch.core import monitoring as tmon  # noqa: E402
from repro_torch.core import run_sequential  # noqa: E402
from repro_torch.core import tensor_util as tu  # noqa: E402
from repro_torch.core.registry import (  # noqa: E402
    Ev, FieldSpec, PayloadSpec, ScenarioBuilderBase, registry_of)
from repro_torch.core.components import BUILTIN  # noqa: E402
from repro_torch.scenarios import cache as tcache  # noqa: E402

from test_torch_engine import assert_states_equal, np_tree  # noqa: E402

STATE_LEAVES = ("counters", "t_now", "done", "windows", "trace", "trace_n",
                "trace_tail")


def assert_builds_equal(tbuilt, jbuilt):
    """The port's built scenario equals the reference's, field by field."""
    for name, t, j in zip(("world", "own", "init"), tbuilt[:3], jbuilt[:3]):
        assert t._fields == j._fields, name
        assert_states_equal({f: getattr(t, f).numpy() for f in t._fields},
                            np_tree(j), name)
    assert dataclasses.asdict(tbuilt[3]) == dataclasses.asdict(jbuilt[3])


def jax_state(st):
    return {"world": np_tree(st.world), "pool": np_tree(st.pool),
            **{k: np.asarray(getattr(st, k)) for k in STATE_LEAVES}}


def full_rows(trace):
    """A trace in full-row order: where ``(time, seq)`` ties occur the
    engine's merge may order the tied rows either way."""
    return sorted(trace)


def run_engines_and_oracles(tbuilt, jbuilt, trace_cap=4096):
    """JAX ``run_local`` (stitched) and its oracle against the port's
    stitched and fused ``run_local`` and oracle, on the CPU. Every port run's
    world, counters, pool, cursors and trace buffers equal the JAX run's;
    the merged traces equal the oracle's in full-row order; the oracles'
    worlds, counters and traces are equal. Returns the JAX state and the
    JAX oracle's trace."""
    st = JEngine(*jbuilt, trace_cap=trace_cap).run_local()
    jax.block_until_ready(st.counters)
    jstate = jax_state(st)
    ow, oc, otrace = j_run_sequential(*jbuilt)
    for fused in (False, True):
        spec = dataclasses.replace(tbuilt[3], fused_select=fused)
        tst = Engine(*tbuilt[:3], spec, trace_cap=trace_cap,
                     device="cpu").run_local()
        tstate = convert.state_to_numpy(tst)
        assert_states_equal(tstate, jstate, f"fused={fused}")
        assert full_rows(merged_engine_trace(tstate["trace"],
                                             tstate["trace_n"])) == \
            full_rows(otrace)
    tw, tc, ttrace = run_sequential(*tbuilt)
    assert_states_equal({f: getattr(tw, f).numpy() for f in tw._fields},
                        np_tree(ow), "oracle world")
    np.testing.assert_array_equal(tc.numpy(), np.asarray(oc))
    assert ttrace == otrace
    return jstate, otrace


# ---------------------------------------------------------- handlers by lane
def check_handler_lanes(treg, jreg, jworld, kind, rows, lookahead=2):
    """Handler ``kind`` over the lanes ``rows`` (a dict of (B,) numpy event
    fields) on a one-agent world: the port's lane-wise handler against the
    reference's handler vmapped over the lanes (delta, counter increments,
    valid emits)."""
    jfn = jreg.make_handlers(lookahead, 1.0)[kind]
    zero = jnp.zeros((jreg.n_counters,), jnp.int32)
    je = jev.EventBatch(**{k: jnp.asarray(v) for k, v in rows.items()})
    d_j, c_j, o_j = jax.jit(jax.vmap(lambda e: jfn(jworld, zero, e)))(je)
    tw = treg.world_struct()(**{k: torch.from_numpy(np.array(v))[None]
                                for k, v in np_tree(jworld).items()})
    B = rows["time"].shape[0]
    e = Ev(*(torch.from_numpy(np.array(rows[k])) for k in Ev._fields[:7]),
           agent=torch.zeros((B,), dtype=torch.int32))
    d_t, c_t, o_t = treg.make_handlers(lookahead, 1.0)[kind](
        tw, tmon.zero_counters(treg.n_counters, B), e)
    assert d_t, "the handler wrote no row"
    dj = np_tree(d_j)
    for name, v in d_t.items():
        assert_states_equal(v.numpy(), dj[name], f"delta {name}")
    assert_states_equal(c_t.numpy(), np.asarray(c_j), "counters")
    oj = np_tree(o_j)
    valid = oj["valid"]
    assert valid.any()
    assert_states_equal(o_t.valid.numpy(), valid, "emit valid")
    for f, v in oj.items():
        assert_states_equal(getattr(o_t, f).numpy()[valid], v[valid],
                            f"emit {f}")


def event_rows(rng, kind, dst, payload):
    B = len(dst)
    return dict(time=rng.integers(40, 60, B).astype(np.int32),
                seq=rng.integers(0, 1 << 30, B).astype(np.int32),
                kind=np.full(B, kind, np.int32),
                src=rng.integers(0, 4, B).astype(np.int32),
                dst=np.asarray(dst, np.int32),
                ctx=np.zeros(B, np.int32),
                payload=np.asarray(payload, np.float32),
                valid=np.ones(B, bool))


def foreign_lanes_run(treg, tworld, rng, B=64):
    """Every handler over lanes of random kinds, destinations, rows and
    payload bits (what ``dispatch_delta`` hands a handler for the lanes of
    other kinds): every gather and scatter stays inside its table."""
    n_lp = tworld.lp_kind.shape[1]
    pay = rng.integers(-2**31, 2**31, (B, tev.PAYLOAD), dtype=np.int64)
    e = Ev(time=torch.from_numpy(rng.integers(0, 100, B).astype(np.int32)),
           seq=torch.from_numpy(rng.integers(0, 1 << 30, B).astype(np.int32)),
           kind=torch.from_numpy(rng.integers(-2, 20, B).astype(np.int32)),
           src=torch.from_numpy(rng.integers(-5, n_lp + 5, B)
                                .astype(np.int32)),
           dst=torch.from_numpy(rng.integers(-5, n_lp + 5, B)
                                .astype(np.int32)),
           ctx=torch.zeros((B,), dtype=torch.int32),
           payload=torch.from_numpy(pay.astype(np.int32).view(np.float32)),
           agent=torch.zeros((B,), dtype=torch.int32))
    for fn in treg.make_handlers(2, 1.0):
        fn(tworld, tmon.zero_counters(treg.n_counters, B), e)


def test_cache_build_handlers_and_runs_equal_reference():
    """The built scenario and each handler by lane; then ``run_local`` and
    the oracle at one agent (the hit and miss counts) and at two (the
    owner-wins sync of the cache rows, with the -1 fill shift of
    cache_keys)."""
    kw = dict(n_caches=4, n_keys=3, n_rounds=5, cache_ways=8)
    tbuilt, tc = tcache.build_churn_scenario(**kw)
    jbuilt, jc = jcache.build_churn_scenario(**kw)
    assert tc == jc
    assert_builds_equal(tbuilt, jbuilt)

    rng = np.random.default_rng(5)
    jw = jbuilt[0]
    keys = rng.integers(-1, 6, np.asarray(jw.cache_keys).shape)
    jw = jw._replace(cache_keys=jnp.asarray(keys, jnp.int32),
                     cache_ptr=jnp.asarray(rng.integers(0, 40, 4), jnp.int32),
                     cache_hits=jnp.asarray(rng.integers(0, 9, 4), jnp.int32),
                     cache_miss=jnp.asarray(rng.integers(0, 9, 4), jnp.int32),
                     cache_hit_lat=jnp.asarray([1, 3, 5, 7], jnp.int32))
    for kind in (tcache.K_CACHE_LOOKUP, tcache.K_CACHE_FILL):
        B = 16
        dst = rng.choice(tc, B)
        payload = np.zeros((B, 8), np.float32)
        payload[:, 0] = rng.integers(0, 6, B)
        payload[:, 1] = rng.random(B) * 4
        payload[:, 2] = rng.integers(-1, 5, B)
        payload[:, 3] = rng.integers(0, 10, B)
        check_handler_lanes(tcache.CACHE_REGISTRY, jcache.CACHE_REGISTRY, jw,
                            kind, event_rows(rng, kind, dst, payload))
    tworld = tbuilt[0].__class__(*(x[None] for x in tbuilt[0]))
    foreign_lanes_run(tcache.CACHE_REGISTRY, tworld, rng)

    for n_agents, kw in ((1, dict(n_caches=4, n_keys=2, n_rounds=3)),
                         (2, dict(n_caches=5, n_keys=2, n_rounds=3))):
        tbuilt, _ = tcache.build_churn_scenario(n_agents=n_agents, **kw)
        jbuilt, _ = jcache.build_churn_scenario(n_agents=n_agents, **kw)
        assert_builds_equal(tbuilt, jbuilt)
        jstate, _ = run_engines_and_oracles(tbuilt, jbuilt)
        c = jstate["counters"].sum(0)
        assert c[tcache.C_CACHE_LOOKUPS] == kw["n_caches"] * kw["n_rounds"]
        assert c[tcache.C_CACHE_FILLS] == kw["n_caches"] * kw["n_keys"]
        if n_agents == 1:
            w = jstate["world"]
            np.testing.assert_array_equal(w["cache_miss"][0, :4], 2)
            np.testing.assert_array_equal(w["cache_hits"][0, :4], 1)
        else:
            assert c[jmon.C_MSGS_REMOTE] > 0


def test_same_row_lookups_and_31bit_payload():
    """Three same-window lookups on one cache row serialise through the
    conflict fallback (a racing fill of key 7 is inserted once): the port's
    stitched and fused engines equal its oracle and the reference's oracle
    (the engines' byte equality with JAX is the test above). A 31-bit int
    payload, a NaN and a denormal bit pattern among them, rides the port's
    stitched and fused engines and its oracle unchanged."""
    def same_row(m):
        b = m.CacheScenarioBuilder(cache_ways=4, max_cpu=1)
        sink = b.add_idle_lp()
        cache = b.add_cache(cache_hit_lat=1, cache_miss_lat=4)
        for k in (7, 7, 9):
            b.add_event(time=1, kind=m.CACHE_LOOKUP, src=sink, dst=cache,
                        payload=m.CACHE_LOOKUP.pack(key=k, size=1.0))
        return b.build(n_agents=1, lookahead=2, t_end=60, pool_cap=64)

    tbuilt, jbuilt = same_row(tcache), same_row(jcache)
    assert_builds_equal(tbuilt, jbuilt)
    ow, oc, otrace = j_run_sequential(*jbuilt)
    tw, tc, ttrace = run_sequential(*tbuilt)
    assert ttrace == otrace
    np.testing.assert_array_equal(tc.numpy(), np.asarray(oc))
    assert_states_equal({f: getattr(tw, f).numpy() for f in tw._fields},
                        np_tree(ow), "oracle world")
    for fused in (False, True):
        spec = dataclasses.replace(tbuilt[3], fused_select=fused)
        st = Engine(*tbuilt[:3], spec, trace_cap=64, device="cpu").run_local()
        assert merged_engine_trace(st.trace, st.trace_n) == otrace
        assert int(st.counters[0, tmon.C_BATCH_FALLBACK]) >= 3
        for f in tcache.CACHE_REGISTRY.delta_schema:
            assert_states_equal(getattr(st.world, f)[0].numpy(),
                                np.asarray(getattr(ow, f)), f)
    assert int((tw.cache_keys[0] == 7).sum()) == 1

    reg = BUILTIN.extend()
    reg.component("idsink", fields=dict(
        sink_token=FieldSpec((), torch.int32, mutable=True),
        sink_n=FieldSpec((), torch.int32, mutable=True)))
    payload = PayloadSpec(("token", 0, torch.int32), "weight")
    put = reg.kind("TOKEN_PUT", table="idsink", payload=payload)

    @reg.on(put)
    def h_token_put(env, world, counters, e):
        s = tu.take(world.lp_res, e.agent, e.dst)
        delta = env.delta(world, "idsink", s,
                          sink_token=payload.get(e.payload, "token"),
                          sink_n=tu.take(world.sink_n, e.agent, s) + 1)
        return delta, counters, tev.empty_batch((e.time.shape[0],
                                                 tev.MAX_EMIT))

    class B(ScenarioBuilderBase):
        _registry = reg

    tokens = [(1 << 31) - 1, 0x7F800001, 16777217, -5, 3]
    b = B()
    sinks = [b.add_idsink() for _ in tokens]
    for lp, tok in zip(sinks, tokens):
        b.add_event(time=1 + lp, kind=put, src=lp, dst=lp,
                    payload=payload.pack(token=tok, weight=1.0))
    built = b.build(n_agents=2, lookahead=1, t_end=50, pool_cap=64)
    assert registry_of(built[0]) is reg
    ow, _oc, otrace = run_sequential(*built)
    np.testing.assert_array_equal(ow.sink_token.numpy(), tokens)
    for fused in (False, True):
        spec = dataclasses.replace(built[3], fused_select=fused)
        st = Engine(*built[:3], spec, trace_cap=64, device="cpu").run_local()
        np.testing.assert_array_equal(st.world.sink_token[0].numpy(), tokens)
        np.testing.assert_array_equal(st.world.sink_n[0].numpy(), 1)
        assert merged_engine_trace(st.trace, st.trace_n) == otrace
