"""The port's engine against JAX ``run_local`` and the sequential oracle.

The same built scenario goes through both packages (JAX -> numpy ->
``repro_torch.convert``); trace, counters, world (floats by bit pattern),
pool and ring cursors must be byte-equal after the run, and the port's
merged trace and oracle must equal the JAX oracle's. This file runs the
T0/T1 model with one agent at exec_cap 1 and 7 (spilling safe events to
later windows) and the default 256; test_torch_engine_scan.py runs the
sequential fold and the port's oracle, test_torch_engine_grid.py the
multi-agent models.

Each JAX configuration compiles for about 10 s, so each is one test, and
these files hold few tests. The tier-1 run's xdist ``loadfile`` hands out
files with the most tests first, so few-test files run last, beside the
suite's long property tests, on workers that would otherwise be idle.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several worker processes on one machine: keep torch to one
# thread each, as the tensors here are small
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.core import Engine as JEngine  # noqa: E402
from repro.core.engine import fused_select_xla  # noqa: E402
from repro.core.registry import registry_of  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import Engine, merged_engine_trace  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402

from conftest import t0t1_builder  # noqa: E402

STATE_LEAVES = ("counters", "t_now", "done", "windows", "trace", "trace_n",
                "trace_tail")


def np_tree(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def port_scenario(world, own, init_ev, spec):
    """The JAX-built scenario as the port's tensors (through numpy; an
    adaptive exec policy as the dict of its fields)."""
    fields = {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}
    if not isinstance(fields["exec_policy"], int):
        fields["exec_policy"] = dataclasses.asdict(fields["exec_policy"])
    return convert.scenario_from_numpy(
        np_tree(world), np_tree(own), np_tree(init_ev), fields)


def run_both(builder, build_kw, trace_cap, port_twin=False):
    """Build once with the JAX builder; run JAX ``run_local`` and the port
    on the CPU. Returns (jax state as numpy, port state as numpy, the JAX
    scenario, the port scenario). Under ``fused_select`` the JAX engine
    takes the stitched twin ``fused_select_xla`` as its ``fused_fn`` (the
    JAX suite holds it byte-equal to the Pallas megakernel, which costs
    minutes in interpret mode); the port takes its defaults, the plain
    ``fused_select`` and ``ring_slots`` on the CPU, or with ``port_twin``
    its own ``fused_select_xla``."""
    world, own, init_ev, spec = builder.build(**build_kw)
    hooks, port_hooks = {}, {}
    if spec.fused_select:
        reg = registry_of(world)
        kw = dict(n_kinds=reg.n_kinds, n_res=reg.max_rows(world),
                  n_tables=reg.n_tables)
        hooks["fused_fn"] = functools.partial(fused_select_xla, **kw)
        if port_twin:
            port_hooks["fused_fn"] = functools.partial(
                teng.fused_select_xla, **kw)
    st = JEngine(world, own, init_ev, spec, trace_cap=trace_cap,
                 **hooks).run_local()
    jax.block_until_ready(st.counters)
    jstate = {"world": np_tree(st.world), "pool": np_tree(st.pool),
              **{k: np.asarray(getattr(st, k)) for k in STATE_LEAVES}}
    scen = port_scenario(world, own, init_ev, spec)
    tst = Engine(*scen, trace_cap=trace_cap, device="cpu",
                 **port_hooks).run_local()
    return jstate, convert.state_to_numpy(tst), (world, own, init_ev, spec), \
        scen


def assert_states_equal(got, want, path="state"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_states_equal(got[k], want[k], f"{path}.{k}")
        return
    g, w = np.ascontiguousarray(got), np.ascontiguousarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (path, g.shape, w.shape)
    if w.dtype == np.float32:
        g, w = g.view(np.int32), w.view(np.int32)
    np.testing.assert_array_equal(g, w, err_msg=path)


def merged(state):
    return merged_engine_trace(state["trace"], state["trace_n"])


def assert_run_matches(jstate, tstate, oracle_trace):
    """Byte-equal states, and the port's merged trace equal to the
    oracle's."""
    assert_states_equal(tstate, jstate)
    assert merged(tstate) == oracle_trace


def t0t1_run_both(n_agents=1, port_twin=False, **opt):
    b, kw = t0t1_builder()
    return run_both(b, dict(n_agents=n_agents, **kw, **opt), trace_cap=512,
                    port_twin=port_twin)


@pytest.mark.parametrize("exec_cap", [1, 7, 256])
def test_t0t1_equals_jax_run_local_and_oracle(exec_cap, t0t1_oracle):
    jstate, tstate, _, _ = t0t1_run_both(exec_cap=exec_cap)
    assert jstate["windows"][0] > 1 and jstate["counters"][0, 0] > 50
    assert_run_matches(jstate, tstate, t0t1_oracle[2])
