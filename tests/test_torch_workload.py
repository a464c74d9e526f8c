"""The port's workload bridge against the reference's.

``repro_torch.core.workload.simulate_training`` must return JAX
``repro.core.workload.simulate_training``'s dict exactly, and the port's
merged trace must equal its sequential oracle. The reference's WAN region
has a 4-link table and asserts that the pods fit, so above 4 pods its
builder is given the port's table of ``n_pods`` links (the scenario is
otherwise its own). At 25 pods the region has 50 flow slots, so the
one-agent conflict fallback's one-lane rows take the tabled flow-sum order
(``kernels/ref.py``). Each JAX run compiles for about 10 s, so this file
holds three tests (see test_torch_engine.py).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# the suite runs several worker processes on one machine: keep torch to one
# thread each, as the tensors here are small
torch.set_num_threads(1)

from repro.core import workload as jwork  # noqa: E402
from repro.core.components import ScenarioBuilder as JBuilder  # noqa: E402
from repro_torch.core import Engine, merged_engine_trace  # noqa: E402
from repro_torch.core import run_sequential  # noqa: E402
from repro_torch.core import workload as twork  # noqa: E402


def jax_simulate(cell, monkeypatch):
    if cell.n_pods > 4:
        monkeypatch.setattr(jwork, "ScenarioBuilder", lambda **kw: JBuilder(
            **{**kw, "max_link": cell.n_pods}))
    return jwork.simulate_training(
        jwork.CellModel(**dataclasses.asdict(cell)))


@pytest.mark.parametrize("cell", [
    twork.CellModel(n_pods=2, t_compute_s=0.05, dcn_bytes_per_pod=2e9,
                    n_steps=2),
    twork.CellModel(n_pods=25, t_compute_s=0.05, dcn_bytes_per_pod=2e9,
                    n_steps=2),
    twork.CellModel(n_pods=2, t_compute_s=0.05, dcn_bytes_per_pod=2e9,
                    n_steps=2, slow_pod_factor=1.5),
], ids=["2_pods", "25_pods", "straggler"])
def test_simulate_training_equals_jax_and_oracle(cell, monkeypatch):
    want = jax_simulate(cell, monkeypatch)
    scen = twork.training_scenario(cell)
    st = Engine(*scen, trace_cap=4096, device="cpu").run_local(
        max_windows=200_000)
    got = twork.summarize(cell, st)
    assert got == want
    assert got["steps_done"] > 0 and got["interrupts"] > 0
    _w, _c, oracle = run_sequential(*scen)
    assert merged_engine_trace(st.trace, st.trace_n) == oracle
