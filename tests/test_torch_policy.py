"""The port's adaptive-width policy against ``repro.core.policy``.

Host-side functions only (no engine run): ``ExecPolicy`` validation,
``normalize``, ``default_ladder``, ``window_stats`` and ``choose_rung`` on
the same inputs through both packages, over a small seeded grid, plus the
builder's ``exec_cap``/``exec_policy`` plumbing.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import monitoring as jmon  # noqa: E402
from repro.core import policy as jpol  # noqa: E402
from repro_torch.core import monitoring as tmon  # noqa: E402
from repro_torch.core import policy as tpol  # noqa: E402
from repro_torch.core.components import ScenarioBuilder  # noqa: E402
from repro_torch.core.registry import RegistryError  # noqa: E402

LADDERS = [(64, 256, 1024), (8, 32, 64), (256,), (1, 2, 3, 4096)]


def both(ladder, **kw):
    return jpol.ExecPolicy(ladder=ladder, **kw), tpol.ExecPolicy(
        ladder=ladder, **kw)


@pytest.mark.parametrize("ladder,kw,match", [
    ((64, 64), {}, "ascending"), ((), {}, "non-empty"),
    ((8,), {"init_rung": 3}, "init_rung"), ((0, 4), {}, "positive"),
    ((16, 8), {}, "ascending"), ((8, 16), {"init_rung": -1}, "init_rung")])
def test_policy_validation_matches(ladder, kw, match):
    for pol in (jpol, tpol):
        with pytest.raises(ValueError, match=match):
            pol.ExecPolicy(ladder=ladder, **kw)


def test_policy_fields_and_normalize_match():
    for ladder in LADDERS + [(np.int64(4), 9.0)]:
        jp, tp = both(ladder)
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
        assert type(tp.ladder[0]) is int
    assert tpol.normalize(17) == tpol.ExecPolicy(ladder=(17,))
    tp = tpol.ExecPolicy(ladder=(4, 8), init_rung=1)
    assert tpol.normalize(tp) is tp


@pytest.mark.parametrize("pool_cap", [1, 16, 63, 64, 256, 1000, 1024, 4096,
                                      20000])
@pytest.mark.parametrize("base", [1, 4, 256])
def test_default_ladder_matches(pool_cap, base):
    assert tpol.default_ladder(pool_cap, base) == jpol.default_ladder(
        pool_cap, base)


def test_counter_slots_match():
    for name in ("C_EVENTS", "C_EXEC_SPILL", "C_BATCH_ROWS", "C_POOL_OCC",
                 "N_COUNTERS"):
        assert getattr(tmon, name) == getattr(jmon, name)


@pytest.mark.parametrize("seed", range(6))
def test_window_stats_and_choose_rung_match(seed):
    """Random counter snapshots for 1-8 agents, pool caps and ladders:
    the same stats and, from every rung, the same next rung."""
    rng = np.random.default_rng(seed)
    for _ in range(40):
        A = int(rng.integers(1, 9))
        pool_cap = int(rng.choice([64, 256, 1024]))
        prev = rng.integers(0, 1000, (A, tmon.N_COUNTERS)).astype(np.int32)
        cur = prev + rng.integers(0, int(rng.choice([3, 40, 600])),
                                  (A, tmon.N_COUNTERS)).astype(np.int32)
        cur[:, tmon.C_POOL_OCC] = rng.integers(0, pool_cap + 1, A)
        got = tpol.window_stats(prev, cur, pool_cap)
        want = jpol.window_stats(prev, cur, pool_cap)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        ladder = LADDERS[int(rng.integers(len(LADDERS)))]
        kw = dict(grow_spill=float(rng.choice([0.0, 0.1, 0.5])),
                  grow_occupancy=float(rng.choice([0.5, 0.75, 1.0])),
                  shrink_util=float(rng.choice([0.25, 0.5, 1.0])))
        jp, tp = both(ladder, **kw)
        for rung in range(len(ladder)):
            assert tpol.choose_rung(tp, rung, got) == jpol.choose_rung(
                jp, rung, want)


def test_builder_takes_a_ladder_or_a_width():
    def build(**kw):
        b = ScenarioBuilder(max_cpu=1, queue_cap=2, max_link=1, max_flow=2)
        b.add_idle_lp()
        return b.build(n_agents=1, lookahead=2, t_end=10, pool_cap=64, **kw)

    ladder = tpol.ExecPolicy(ladder=(8, 32), init_rung=1)
    *_, spec = build(exec_policy=ladder)
    assert spec.exec_policy is ladder and spec.exec_cap == 32
    *_, spec = build(exec_cap=17)
    assert spec.exec_policy == 17 and spec.exec_cap == 17
    *_, spec = build()
    assert spec.exec_cap == 64
    with pytest.raises(RegistryError, match="not both"):
        build(exec_cap=4, exec_policy=ladder)


def test_simulate_rejects_a_width_with_a_ladder():
    """``--exec-cap`` with ``--adaptive-exec`` is refused before any run,
    as the reference's CLI refuses it."""
    from repro_torch.launch import simulate
    with pytest.raises(SystemExit, match="conflict"):
        simulate.main(["t0t1", "--adaptive-exec", "--exec-cap", "4",
                       "--device", "cpu"])
