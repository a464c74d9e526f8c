"""Unit tests of the port's host layer, in torch and numpy only: the trace
stream's gap, completeness and duplicate checks, the metrics stream's
validation, booking and checkpoint state, the counter classes, the engine's
refusals (ring too small, no ring, no cadence), its host reads a window, the
order of checkpoint and window hook, and the checkpointer's round trip,
retention and refusals. The JAX comparisons are in test_torch_streams.py
and test_torch_placement.py.
"""
import io
import json
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.checkpoint import (Checkpointer, SimCheckpointer,  # noqa: E402
                                    tree_keys)
from repro_torch.core import Engine  # noqa: E402
from repro_torch.core import monitoring as mon  # noqa: E402
from repro_torch.core.policy import ExecPolicy  # noqa: E402
from repro_torch.launch.simulate import t0t1_scenario  # noqa: E402


def scenario(agents=2, **spec_kw):
    return t0t1_scenario(8.0, 6, agents, **spec_kw)


def ring_of(rows, start, cap=64):
    ring = np.zeros((cap, 4), np.int32)
    ring[(start + np.arange(rows.shape[0])) % cap] = rows
    return ring


def test_counter_classes():
    want = {mon.C_POOL_OCC: "gauge", mon.C_POOL_FREE: "gauge",
            mon.C_DROP_POOL: "drop", mon.C_DROP_ROUTE: "drop",
            mon.C_DROP_FLOW: "drop", mon.C_DROP_QUEUE: "drop",
            mon.C_RING_WRAP: "pool-diag", mon.C_BATCH_EXEC: "batch-diag",
            mon.C_BATCH_FALLBACK: "batch-diag", mon.C_BATCH_ROWS: "batch-diag",
            mon.C_PREEMPT: "fleet", mon.C_RESUME: "fleet",
            mon.C_RESHARD: "fleet"}
    for i in range(mon.N_COUNTERS):
        assert mon.counter_class(i) == want.get(i, "counter"), i


def test_gather_counters_and_performance_value():
    c = torch.zeros((2, mon.N_COUNTERS), dtype=torch.int32)
    c[:, mon.C_EVENTS] = torch.tensor([10, 0])
    c[:, mon.C_WINDOWS] = torch.tensor([4, 0])
    c[:, mon.C_MSGS_REMOTE] = torch.tensor([5, 0])
    assert mon.gather_counters(c) is c
    pv = mon.performance_value(c, torch.tensor([3, 1]), torch.tensor([2, 0]))
    assert pv.dtype == torch.float32
    assert pv.tolist() == [10 / 4 + 4 * 0.5 + 1.5 + 4.0, 0.5]


def test_trace_stream_gap_and_incomplete():
    ring = np.arange(64 * 4, dtype=np.int32).reshape(64, 4)
    ts = mon.TraceStream()
    ts.begin(1)
    with pytest.raises(RuntimeError, match="not finalized"):
        ts.agent_rows(0)
    ts.on_drain(0, 0, 8, ring)
    ts.on_drain(0, 16, 8, ring)          # [8, 16) never arrived
    ts.finalize(ring[None], np.array([24]), np.array([24]))
    with pytest.raises(RuntimeError, match="gap"):
        ts.agent_rows(0)
    ts = mon.TraceStream()
    ts.begin(1)
    ts.on_drain(0, 0, 8, ring)
    ts.on_drain(0, 8, 0, ring)           # an empty span is a no-op
    ts.finalize(ring[None], np.array([12]), np.array([12]))
    with pytest.raises(RuntimeError, match="incomplete"):
        ts.agent_rows(0)
    assert ts.n_streamed == 12


def test_trace_stream_duplicate_spans_and_wrap():
    scen = scenario(agents=2, exec_cap=8)
    ts = mon.TraceStream()
    st = Engine(*scen, trace_cap=16, device="cpu", trace_stream=ts,
                drain_every=3).run_local()
    assert int(st.trace_n.max()) > 16
    want = ts.merged()
    for a, spans in {a: dict(d) for a, d in ts._segments.items()}.items():
        for start, rows in spans.items():
            ts.on_drain(a, start, rows.shape[0], ring_of(rows, start))
    assert ts.merged() == want
    # a span across the ring's end unrolls from (start + i) % cap
    rows = np.arange(20, dtype=np.int32).reshape(5, 4)
    t2 = mon.TraceStream()
    t2.begin(1)
    t2.on_drain(np.array([0]), np.array([62]), np.array([5]),
                ring_of(rows, 62)[None])
    t2.finalize(np.zeros((1, 64, 4), np.int32), np.array([67]),
                np.array([67]))
    with pytest.raises(RuntimeError, match="gap"):
        t2.agent_rows(0)
    np.testing.assert_array_equal(t2._segments[0][62], rows)


def test_metrics_stream_records_book_and_state():
    with pytest.raises(ValueError, match="interval"):
        mon.MetricsStream(interval=0)
    out = io.StringIO()
    ms = mon.MetricsStream(interval=2, out=out)
    ms.begin(2)
    ms.book("PREEMPT", 2)
    ms.book("NOT_A_COUNTER")
    c = np.ones((2, mon.N_COUNTERS), np.int32)
    ms.on_window(0, 1, 5, c[0])          # off the cadence: dropped
    ms.on_window(0, 2, 5, c[0])
    ms.on_window(7, 2, 9, c[1])          # no such agent: dropped
    assert ms.lines == []
    ms.on_window(1, 2, 6, c[1])          # the window is whole: one record
    assert len(ms.lines) == 1 and ms.lines[0]["gvt"] == 6
    assert ms.lines[0]["counters"]["EVENTS"] == 2
    assert ms.lines[0]["counters"]["PREEMPT"] == 4
    ms.finalize(c, np.array([3, 3]), np.array([7, 8]))
    assert ms.latest["final"] and ms.latest["window"] == 3
    assert [json.loads(x) for x in out.getvalue().splitlines()] == ms.lines
    saved = ms.state_dict()
    m2 = mon.MetricsStream(interval=2, out=io.StringIO())
    m2.load_state(saved)
    m2.begin(2)
    assert m2.lines == ms.lines and m2.out.getvalue() == ""
    ms.begin(2)                          # booked counters survive a reset
    ms.finalize(c, np.array([1, 1]), np.array([0, 0]))
    assert ms.lines[-1]["counters"]["PREEMPT"] == 4


def test_engine_refusals():
    scen = scenario(exec_cap=16)
    with pytest.raises(ValueError, match="trace_cap"):
        Engine(*scen, device="cpu", trace_stream=mon.TraceStream())
    with pytest.raises(ValueError, match="drain_every"):
        Engine(*scen, trace_cap=32, device="cpu", drain_every=0)
    eng = Engine(*scen, trace_cap=8, device="cpu",
                 trace_stream=mon.TraceStream())
    with pytest.raises(ValueError, match="ring too small"):
        eng.run_local()
    eng = Engine(*scen, trace_cap=8, device="cpu",
                 trace_stream=mon.TraceStream())
    with pytest.raises(ValueError, match="ring too small"):
        eng.run_adaptive(policy=ExecPolicy(ladder=(4, 16)))
    with pytest.raises(ValueError, match="no checkpointer"):
        eng.restore()


def test_host_reads_and_hook_order(tmp_path):
    scen = scenario(exec_cap=16)
    eng = Engine(*scen, trace_cap=64, device="cpu")
    st = eng.run_local()
    w = int(st.windows[0])
    # a read of the window count, then `done` and the execute's read a
    # window, and the last `done`
    assert eng.host_reads == 2 * w + 2
    eng = Engine(*scen, trace_cap=64, device="cpu")
    eng.run_adaptive(policy=16)
    assert eng.host_reads == 3 * w + 3
    seen = []
    ck = SimCheckpointer(str(tmp_path), every=5, keep=100)

    def hook(window, state):
        seen.append((window, ck.latest_step(), int(state.windows[0])))

    eng = Engine(*scen, trace_cap=64, device="cpu", checkpointer=ck,
                 window_hook=hook)
    eng.run_local(max_windows=12)
    assert [s[0] for s in seen] == list(range(1, 13))
    assert all(a == c and (b or 0) == a // 5 * 5 for a, b, c in seen)
    assert ck.all_steps() == [5, 10]


class Pair(NamedTuple):
    b: torch.Tensor
    a: dict


def test_checkpointer_roundtrip_gc_and_refusals(tmp_path):
    tree = Pair(b=torch.arange(6, dtype=torch.int32).reshape(2, 3),
                a={"z": torch.tensor([1.5, -0.0]), "y": [
                    torch.tensor([True, False]), None,
                    (torch.tensor([7], dtype=torch.int64),)]})
    assert tree_keys(tree) == ["b", "a/y/0", "a/y/2/0", "a/z"]
    ck = Checkpointer(str(tmp_path / "gen"), keep=2)
    for step in (1, 2, 3):
        ck.save(step, tree)
    ck.wait()
    assert ck.all_steps() == [2, 3]
    step, back = ck.restore(tree)
    assert step == 3 and tree_keys(back) == tree_keys(tree)
    for (_, x), (_, y) in zip(*(ck_paths(t) for t in (tree, back))):
        assert x.dtype == y.dtype and torch.equal(x, y)
    with pytest.raises(ValueError, match="structure mismatch"):
        ck.restore({"other": torch.zeros(1)})
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(tree)

    scen = scenario(exec_cap=16)
    eng = Engine(*scen, trace_cap=32, device="cpu",
                 checkpointer=SimCheckpointer(str(tmp_path / "sim"),
                                              every=3, keep=2))
    st = eng.run_local(max_windows=10)
    assert eng.checkpointer.all_steps() == [6, 9]
    rec = eng.restore()
    assert rec.step == 9 and rec.rung is None
    mid = eng.run_local(max_windows=9, state=eng.init_state())
    for x, y in zip(ck_paths(rec.state), ck_paths(mid)):
        assert x[0] == y[0] and torch.equal(x[1], y[1])
    assert int(st.windows[0]) == 10
    other = Engine(*scen, trace_cap=64, device="cpu",
                   checkpointer=SimCheckpointer(str(tmp_path / "sim")))
    with pytest.raises(ValueError, match="shape"):
        other.restore()
    with pytest.raises(ValueError, match="every"):
        SimCheckpointer(str(tmp_path / "neg"), every=-1)


def ck_paths(tree):
    from repro_torch.checkpoint.checkpointer import _tree_paths
    return _tree_paths(tree)
