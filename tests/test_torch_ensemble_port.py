"""The port's ensemble driver on its own, with no JAX: every replica of
``Engine.run_ensemble`` equals a ``run_local`` of its seeded state.

The failure/repair model's replicas end at different windows, so the
driver must freeze each finished replica; ``max_windows`` stops the rest
where ``run_local`` stops. The fused front end, the reference insert and
the dense merge run the same ensembles, 100 replicas keep their books
apart, a custom seed function replaces the default jump, the T0/T1 model's
replicas route between their own agents, and the drivers that cannot run
an ensemble (a trace stream, a checkpointer) refuse it.
"""
import dataclasses
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several worker processes on one machine: keep torch to one
# thread each, as the tensors here are small
torch.set_num_threads(1)

from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import SimCheckpointer  # noqa: E402
from repro_torch.core import Engine, MetricsStream, TraceStream  # noqa: E402
from repro_torch.core import monitoring as mon  # noqa: E402
from repro_torch.core import run_sequential, merged_engine_trace  # noqa: E402
from repro_torch.core.engine import map_state, seed_rng_fields  # noqa: E402
from repro_torch.launch import simulate  # noqa: E402
from repro_torch.scenarios import failures  # noqa: E402

SEEDS = np.arange(6, dtype=np.int32)


@pytest.fixture(scope="module")
def built():
    return failures.build_failure_scenario(n_farms=2, pool_cap=128)[0]


def np_state(st):
    return convert.state_to_numpy(st)


def assert_same(got, want, path="state"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
        return
    assert got.shape == want.shape and got.dtype == want.dtype, path
    if want.dtype == np.float32:
        got, want = got.view(np.int32), want.view(np.int32)
    np.testing.assert_array_equal(got, want, err_msg=path)


def replica(st, r):
    return np_state(map_state(lambda x: x[r], st))


def run_local_seeded(built, seed, trace_cap=512, spec=None, **kw):
    eng = Engine(*built[:3], spec or built[3], trace_cap=trace_cap,
                 device="cpu")
    st = seed_rng_fields(eng.init_state(), torch.tensor(seed, dtype=torch.int32))
    return np_state(eng.run_local(state=st, **kw))


@pytest.mark.parametrize("option", ["stitched", "fused", "insert_ref",
                                    "merge_dense"])
def test_every_replica_equals_its_run_local(built, option):
    spec = dict(stitched={}, fused=dict(fused_select=True),
                insert_ref=dict(insert_mode="ref"),
                merge_dense=dict(merge_mode="dense"))[option]
    spec = dataclasses.replace(built[3], **spec)
    out = Engine(*built[:3], spec, trace_cap=512,
                 device="cpu").run_ensemble(SEEDS)
    assert out.windows.shape == (6, 1) and bool(out.done.all())
    for r, seed in enumerate(SEEDS):
        assert_same(replica(out, r), run_local_seeded(built, seed, spec=spec),
                    f"{option} replica {r}")
    if option != "stitched":
        base = Engine(*built, trace_cap=512, device="cpu").run_ensemble(SEEDS)
        keys = ("trace", "trace_n", "windows", "t_now", "done")
        assert_same({k: np_state(out)[k] for k in keys},
                    {k: np_state(base)[k] for k in keys}, option)
        assert_same(np_state(out)["world"], np_state(base)["world"], option)


def test_one_replica_and_frozen_replicas(built):
    # seed 0 perturbs nothing: a one-replica ensemble is run_local itself
    one = Engine(*built, trace_cap=512, device="cpu").run_ensemble([0])
    plain = np_state(Engine(*built, trace_cap=512, device="cpu").run_local())
    assert_same(replica(one, 0), plain, "one replica")
    # replicas end apart; each stops counting at its own end
    out = Engine(*built, trace_cap=512, device="cpu").run_ensemble(SEEDS)
    windows = out.windows[:, 0].tolist()
    assert len(set(windows)) > 1
    np.testing.assert_array_equal(
        out.counters[:, 0, mon.C_WINDOWS].numpy(), windows)
    # a window cap between the ends: the long replicas stop there
    cap = sorted(windows)[len(windows) // 2]
    capped = Engine(*built, trace_cap=512,
                    device="cpu").run_ensemble(SEEDS, max_windows=cap)
    assert capped.windows[:, 0].tolist() == [min(w, cap) for w in windows]
    for r, seed in enumerate(SEEDS):
        assert_same(replica(capped, r),
                    run_local_seeded(built, seed, max_windows=cap),
                    f"capped replica {r}")
    # and the oracle of the seeded world is each replica's merged trace
    world, own, init_ev, spec = built
    for r in (1, 4):
        seeded = world._replace(fp_rng=seed_rng_fields(
            Engine(*built, device="cpu").init_state(),
            torch.tensor(r, dtype=torch.int32)).world.fp_rng[0])
        otrace = run_sequential(seeded, own, init_ev, spec)[2]
        st = replica(out, r)
        assert merged_engine_trace(st["trace"], st["trace_n"]) == otrace


def test_hundred_replicas_books_recoverable(built):
    ms = MetricsStream(interval=1_000_000, out=io.StringIO())
    R = 100
    out = Engine(*built, metrics_stream=ms, device="cpu").run_ensemble(
        np.arange(R))
    counters = out.counters.numpy()
    assert counters.shape[0] == R and bool(out.done.all())
    assert ms.replica_counters.shape == (R, counters.shape[2])
    assert [ms.replica(r)["EVENTS"] for r in range(R)] == list(
        counters[:, :, mon.C_EVENTS].sum(axis=1))
    windows = out.windows[:, 0].numpy()
    assert len(set(windows.tolist())) > 1
    rec = json.loads(ms.out.getvalue().strip().splitlines()[-1])
    assert rec == ms.latest and rec["ensemble"] == R
    assert rec["counters"]["EVENTS"] == int(counters[:, :,
                                                     mon.C_EVENTS].sum())
    assert rec["per_replica"]["WINDOWS"]["max"] == int(windows.max())
    assert rec["windows"] == [int(windows.min()), int(windows.max())]


def test_custom_seed_fn_and_int32_jump():
    small = failures.build_failure_scenario(n_farms=1, pool_cap=64)[0]

    def sfn(state, seed):
        return state._replace(world=state.world._replace(
            fp_rng=state.world.fp_rng * 0 + seed))

    out = Engine(*small, device="cpu").run_ensemble([11, 11, 42],
                                                     seed_fn=sfn)
    c = out.counters.numpy()
    assert (c[0] == c[1]).all()
    assert torch.equal(out.world.fp_rng[0], out.world.fp_rng[1])
    # the default jump wraps as int32 arithmetic does
    st = Engine(*small, device="cpu").init_state()
    for seed in (1, -7, 2**31 - 1, -2**31, 271_828):
        got = seed_rng_fields(st, torch.tensor(seed, dtype=torch.int32))
        v = st.world.fp_rng.numpy().astype(np.int64) + seed * 7919
        want = ((v + 2**31) % 2**32 - 2**31).astype(np.int32)
        np.testing.assert_array_equal(got.world.fp_rng.numpy(), want)
        assert got.world.fp_rng.dtype == torch.int32
        assert got.world.fp_burst is st.world.fp_burst


def test_two_agent_replicas_route_within_their_replica():
    scen = simulate.t0t1_scenario(2.0, 12, 2)
    out = Engine(*scen, trace_cap=256, device="cpu").run_ensemble([0, 1, 2])
    plain = np_state(Engine(*scen, trace_cap=256, device="cpu").run_local())
    for r in range(3):
        assert_same(replica(out, r), plain, f"t0t1 replica {r}")
    assert int(plain["counters"][:, mon.C_MSGS_REMOTE].sum()) > 0


def test_streams_and_checkpoints_are_refused(built, tmp_path):
    eng = Engine(*built, trace_cap=64, trace_stream=TraceStream(),
                 device="cpu")
    with pytest.raises(ValueError, match="cannot stream traces"):
        eng.run_ensemble([0, 1])
    eng2 = Engine(*built, device="cpu",
                  checkpointer=SimCheckpointer(str(tmp_path), every=4))
    with pytest.raises(ValueError, match="checkpoint cadence"):
        eng2.run_ensemble([0, 1])
    # the refusals leave the engine unreplicated
    assert eng._replicas == 1 and eng2._replicas == 1
