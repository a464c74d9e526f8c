"""The port's adaptive exec width (``Engine.run_adaptive``) against JAX.

On test_policy.py's spill-heavy scenario (every window offers 512 same-tick
events) with a ladder that grows from 256 to 512, the port's rung
trajectory, windows, trace, counters, world, pool and ring cursors must
equal JAX ``run_adaptive``'s, and its merged trace the sequential oracle's.
A one-rung ladder must equal ``run_local``. Each JAX rung compiles its own
window program (about 10 s), so this file holds two tests (see
test_torch_engine.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several worker processes on one machine: keep torch to one
# thread each, as the tensors here are small
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.core import Engine as JEngine  # noqa: E402
from repro.core import policy as jpol  # noqa: E402
from repro.core import run_sequential as j_run_sequential  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import Engine  # noqa: E402

from test_policy import spill_heavy  # noqa: E402
from test_torch_engine import (STATE_LEAVES, assert_run_matches,  # noqa: E402
                               assert_states_equal, np_tree, port_scenario)


def test_run_adaptive_equals_jax_and_oracle():
    scen = spill_heavy(width=512, exec_policy=jpol.ExecPolicy(
        ladder=(256, 512)))
    jeng = JEngine(*scen, trace_cap=4096)
    jst = jeng.run_adaptive()
    jax.block_until_ready(jst.counters)
    jstate = {"world": np_tree(jst.world), "pool": np_tree(jst.pool),
              **{k: np.asarray(getattr(jst, k)) for k in STATE_LEAVES}}
    eng = Engine(*port_scenario(*scen), trace_cap=4096, device="cpu")
    tstate = convert.state_to_numpy(eng.run_adaptive())
    assert eng.adaptive_rungs == jeng.adaptive_rungs
    assert max(eng.adaptive_rungs) == 1          # the ladder grew
    _w, _c, oracle = j_run_sequential(*scen)
    assert_run_matches(jstate, tstate, oracle)


def test_one_rung_ladder_equals_run_local():
    scen = port_scenario(*spill_heavy(width=64, exec_cap=256))
    st_s = Engine(*scen, trace_cap=4096, device="cpu").run_local()
    eng = Engine(*scen, trace_cap=4096, device="cpu")
    st_a = eng.run_adaptive(policy=256)
    assert eng.adaptive_rungs == (0,) * int(st_s.windows[0])
    assert_states_equal(convert.state_to_numpy(st_a),
                        convert.state_to_numpy(st_s))
