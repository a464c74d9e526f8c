"""The port's host layer against the reference's: streamed runs and their
checkpoints, byte for byte.

The T0/T1 model at 4 agents with twice conftest's flows, so every agent's
trace outgrows the ring, runs with a trace stream, a metrics stream and a
checkpoint every 6 windows through both packages: stitched ``run_local``
(exec width 8, ring 16, a drain every window; width 16, ring 24, a drain
every 5), the fused front end (width 16, ring 16, every 5) and
``run_adaptive`` over the ladder (4, 16) (ring 24, every window). Held
equal: the final state with its ring and ``trace_tail``, the drained spans
key for key, the metrics records, the merged trace (also against the
port's oracle), and every checkpoint's arrays and manifest. Then each
package resumes the other's checkpoint from the first step past the ring
and continues to the uninterrupted run's state, trace and records.

The JAX engines compile once a configuration (about 10 s each, the
adaptive one a program a rung), in one module fixture, so this file holds
two tests and queues behind the three-test files (see
test_torch_engine.py).
"""
import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several worker processes on one machine: keep torch to one
# thread each, as the tensors here are small
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.checkpoint import SimCheckpointer as JSimCheckpointer  # noqa: E402
from repro.checkpoint import tree_keys as j_tree_keys  # noqa: E402
from repro.core import Engine as JEngine  # noqa: E402
from repro.core import monitoring as jmon  # noqa: E402
from repro.core.engine import fused_select_xla  # noqa: E402
from repro.core.policy import ExecPolicy  # noqa: E402
from repro.core.registry import registry_of  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import SimCheckpointer, tree_keys  # noqa: E402
from repro_torch.core import Engine, run_sequential  # noqa: E402
from repro_torch.core import monitoring as tmon  # noqa: E402

from conftest import t0t1_builder  # noqa: E402
from test_torch_engine import (assert_states_equal, np_tree,  # noqa: E402
                               port_scenario)

STATE_LEAVES = ("counters", "t_now", "done", "windows", "trace", "trace_n",
                "trace_tail")
N_AGENTS, N_FLOWS, CK_EVERY, METRICS_EVERY = 4, 24, 6, 4
CASES = {
    "stitched w8 ring16 drain1": dict(width=8, ring=16, drain=1),
    "stitched w16 ring24 drain5": dict(width=16, ring=24, drain=5),
    "fused w16 ring16 drain5": dict(width=16, ring=16, drain=5, fused=True),
    "adaptive (4, 16) ring24 drain1": dict(ladder=(4, 16), ring=24, drain=1),
}


def jax_state(st):
    return {"world": np_tree(st.world), "pool": np_tree(st.pool),
            **{k: np.asarray(getattr(st, k)) for k in STATE_LEAVES}}


def build(case):
    b, kw = t0t1_builder(n_flows=N_FLOWS)
    if "ladder" in case:
        kw["exec_policy"] = ExecPolicy(ladder=case["ladder"])
    else:
        kw["exec_cap"] = case["width"]
    return b.build(n_agents=N_AGENTS, fused_select=case.get("fused", False),
                   **kw)


def jax_engine(built, case, ckdir):
    hooks = {}
    if case.get("fused"):
        reg = registry_of(built[0])
        hooks["fused_fn"] = functools.partial(
            fused_select_xla, n_kinds=reg.n_kinds,
            n_res=reg.max_rows(built[0]), n_tables=reg.n_tables)
    return JEngine(*built, trace_cap=case["ring"],
                   trace_stream=jmon.TraceStream(),
                   metrics_stream=jmon.MetricsStream(METRICS_EVERY),
                   drain_every=case["drain"],
                   checkpointer=JSimCheckpointer(ckdir, every=CK_EVERY,
                                                 keep=1000), **hooks)


def port_engine(scen, case, ckdir, every=CK_EVERY):
    return Engine(*scen, trace_cap=case["ring"], device="cpu",
                  trace_stream=tmon.TraceStream(),
                  metrics_stream=tmon.MetricsStream(METRICS_EVERY),
                  drain_every=case["drain"],
                  checkpointer=SimCheckpointer(ckdir, every=every,
                                               keep=1000))


def drive(eng, case, rec=None):
    state, rung = (None, None) if rec is None else (rec.state, rec.rung)
    if "ladder" in case:
        return eng.run_adaptive(state=state, rung=rung)
    return eng.run_local(state=state)


def run(stream_eng, case, rec=None):
    """One streamed run: (state as numpy, spans, records, merged trace)."""
    st = drive(stream_eng, case, rec)
    if isinstance(st.counters, torch.Tensor):
        state = convert.state_to_numpy(st)
    else:
        jax.block_until_ready(st.counters)
        state = jax_state(st)
    ts, ms = stream_eng.trace_stream, stream_eng.metrics_stream
    return dict(state=state, spans=ts.state_dict(), lines=ms.lines,
                merged=ts.merged())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    oracle = None
    for name, case in CASES.items():
        d = tmp_path_factory.mktemp("ck")
        jdir, tdir = str(d / "jax"), str(d / "port")
        built = build(case)
        scen = port_scenario(*built)
        jeng = jax_engine(built, case, jdir)
        teng = port_engine(scen, case, tdir)
        if oracle is None:
            oracle = run_sequential(*scen)[2]
        out[name] = dict(case=case, scen=scen, jeng=jeng, jdir=jdir,
                         tdir=tdir, jax=run(jeng, case), port=run(teng, case),
                         oracle=oracle)
    return out


def npz_arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_streamed_runs_and_checkpoints_equal_jax(runs):
    for name, r in runs.items():
        j, t, ring = r["jax"], r["port"], r["case"]["ring"]
        assert_states_equal(t["state"], j["state"], name)
        # the ring really wrapped, and nothing was overwritten un-drained
        assert int(j["state"]["trace_n"].max()) > ring, name
        assert int(t["state"]["counters"][:, tmon.C_TRACE_DROP].sum()) == 0
        assert list(t["spans"]) == list(j["spans"]), name
        for k, rows in j["spans"].items():
            assert_states_equal(t["spans"][k], rows, f"{name} span {k}")
        assert t["lines"] == j["lines"], name
        assert t["lines"][-1]["final"]
        assert t["merged"] == j["merged"] == r["oracle"], name
        steps = sorted(os.listdir(r["jdir"]))
        assert steps == sorted(os.listdir(r["tdir"])) and len(steps) >= 3
        for s in steps:
            with open(os.path.join(r["jdir"], s, "manifest.json")) as f:
                jm = f.read()
            with open(os.path.join(r["tdir"], s, "manifest.json")) as f:
                assert f.read() == jm, (name, s)
            ja = npz_arrays(os.path.join(r["jdir"], s, "host_0.npz"))
            ta = npz_arrays(os.path.join(r["tdir"], s, "host_0.npz"))
            assert list(ta) == list(ja)
            assert sorted(ja) == json.loads(jm)["keys"]
            assert_states_equal(ta, ja, f"{name} {s}")


def past_the_ring(ckdir, ring):
    """The first checkpoint step whose saved trace_n exceeds the ring."""
    ck = SimCheckpointer(ckdir)
    for step in ck.all_steps():
        _, blob, _ = ck._read_step(step)
        if int(blob["state/trace_n"].max()) > ring:
            return step
    raise AssertionError("no checkpoint past the ring")


def test_each_package_resumes_the_others_checkpoint(runs):
    first = next(iter(runs.values()))
    jst = first["jeng"].init_state()
    tst = Engine(*first["scen"], trace_cap=first["case"]["ring"],
                 device="cpu").init_state()
    assert tree_keys(tst) == j_tree_keys(jst)
    for name, r in runs.items():
        case = r["case"]
        step = past_the_ring(r["jdir"], case["ring"])
        assert step == past_the_ring(r["tdir"], case["ring"])
        # the port continues JAX's checkpoint
        teng = port_engine(r["scen"], case, r["jdir"], every=0)
        rec = teng.restore(step)
        assert rec.step == step
        got = run(teng, case, rec)
        assert_states_equal(got["state"], r["port"]["state"], name)
        assert got["merged"] == r["port"]["merged"], name
        assert got["lines"] == r["port"]["lines"], name
        # JAX continues the port's (the same compiled engine, fresh streams)
        jeng = r["jeng"]
        jeng.checkpointer = JSimCheckpointer(r["tdir"], every=0)
        jeng.trace_stream = jmon.TraceStream()
        jeng.metrics_stream = jmon.MetricsStream(METRICS_EVERY)
        got = run(jeng, case, jeng.restore(step))
        assert_states_equal(got["state"], r["jax"]["state"], name)
        assert got["merged"] == r["jax"]["merged"], name
        assert got["lines"] == r["jax"]["lines"], name
