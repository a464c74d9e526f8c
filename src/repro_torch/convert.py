"""What crosses between the two packages, as plain numpy: a built scenario
and an engine state of the simulator, and the parameters of a model-zoo
model.

The simulator has no weights; the model zoo has. Callers that hold JAX
objects turn them into dicts of numpy arrays themselves (for example
``{k: np.asarray(v) for k, v in world._asdict().items()}``, or a params tree
flattened to ``{"layers/attn/wq": array, ...}``); this module never sees a
JAX object.
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
    """numpy to torch on ``device`` (a copy), bfloat16 (the ``ml_dtypes``
    numpy type of JAX's bfloat16 arrays) included."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


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


def model_params_from_numpy(cfg, flat: dict, device="cpu") -> dict:
    """The port's parameters (a ``Model.state_dict()``) from the reference
    model's params: ``flat`` maps each tree path joined with ``/`` (for
    example ``layers/attn/wq``) to a numpy array, the leaves of the layer
    stacks (``layers``, ``first_layers``, ``encoder``) stacked on a leading
    layer axis. Keys, shapes and dtypes must match the
    port's ``Model(cfg)``; returns the tensors on ``device``."""
    from repro_torch.models.model import Model
    want = Model(cfg, device="meta").state_dict()
    out = {}
    for key, arr in flat.items():
        parts = key.split("/")
        t = _t(arr, "cpu")
        if parts[0] in ("layers", "first_layers", "encoder"):
            for i in range(t.shape[0]):
                out[".".join([parts[0], str(i), *parts[1:]])] = t[i]
        else:
            out[".".join(parts)] = t
    if set(out) != set(want):
        raise ValueError(f"params do not match {cfg.name}: missing "
                         f"{sorted(set(want) - set(out))}, unknown "
                         f"{sorted(set(out) - set(want))}")
    for k, t in out.items():
        if t.shape != want[k].shape or t.dtype != want[k].dtype:
            raise ValueError(f"{k}: {t.dtype} {tuple(t.shape)}, the model "
                             f"holds {want[k].dtype} {tuple(want[k].shape)}")
    return {k: t.to(device) for k, t in out.items()}
