"""What crosses between the two packages: a built scenario and an engine
state, as plain numpy.

The system has no weights. Callers that hold JAX objects turn them into
dicts of numpy arrays themselves (for example
``{k: np.asarray(v) for k, v in world._asdict().items()}``); this module
never sees a JAX object.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import events as ev
from repro_torch.core.components import BUILTIN
from repro_torch.core.engine import EngineState
from repro_torch.core.policy import ExecPolicy
from repro_torch.core.registry import ScenarioSpec

_STATE_LEAVES = ("counters", "t_now", "done", "windows", "trace", "trace_n",
                 "trace_tail")


def _t(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def scenario_from_numpy(world: dict, own: dict, init_events: dict,
                        spec: dict, device="cpu", registry=BUILTIN):
    """``(World, WorldOwnership, EventBatch, ScenarioSpec)`` of the port
    from dicts of numpy arrays and a plain spec dict (an adaptive
    ``exec_policy`` as the dict of its ``ExecPolicy`` fields)."""
    if isinstance(spec.get("exec_policy"), dict):
        spec = {**spec, "exec_policy": ExecPolicy(**spec["exec_policy"])}
    World = registry.world_struct()
    Own = registry.ownership_struct()
    return (World(**{k: _t(world[k], device) for k in World._fields}),
            Own(**{k: _t(own[k], device) for k in Own._fields}),
            ev.EventBatch(**{k: _t(init_events[k], device)
                             for k in ev.EventBatch._fields}),
            ScenarioSpec(**spec))


def state_from_numpy(state: dict, device="cpu", registry=BUILTIN
                     ) -> EngineState:
    """An ``EngineState`` from ``{"world": {...}, "pool": {...}, leaf: ...}``
    (the layout :func:`state_to_numpy` returns)."""
    World = registry.world_struct()
    return EngineState(
        world=World(**{k: _t(state["world"][k], device)
                       for k in World._fields}),
        pool=ev.EventPool(**{k: _t(state["pool"][k], device)
                             for k in ev.EventPool._fields}),
        **{k: _t(state[k], device) for k in _STATE_LEAVES})


def state_to_numpy(st: EngineState) -> dict:
    """Every leaf of an ``EngineState`` as a numpy array: the pool with its
    ring cursors, the world, the counters and the trace."""
    def n(x):
        return x.detach().cpu().numpy()
    return {"world": {k: n(v) for k, v in st.world._asdict().items()},
            "pool": {k: n(v) for k, v in st.pool._asdict().items()},
            **{k: n(getattr(st, k)) for k in _STATE_LEAVES}}
