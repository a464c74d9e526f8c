"""What crosses between the two packages, as plain numpy: a built scenario
and an engine state of the simulator, and the parameters of a model-zoo
model.

The simulator has no weights; the model zoo has. Callers that hold JAX
objects turn them into dicts of numpy arrays themselves (for example
``{k: np.asarray(v) for k, v in world._asdict().items()}``, or a params tree
flattened to ``{"layers/attn/wq": array, ...}``); this module never sees a
JAX object. A model's gradients and AdamW moments are trees congruent with
its parameters, so they cross the same way, both ways
(:func:`model_params_from_numpy`, :func:`model_params_to_numpy`).
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


_STACKS = ("layers", "first_layers", "encoder")


def leaf_path(name: str) -> str:
    """The reference's params path of a port parameter: ``layers.3.attn.wq``
    -> ``layers/attn/wq`` (the layer stacks hold one leaf for all layers)."""
    parts = name.split(".")
    if parts[0] in _STACKS:
        del parts[1]
    return "/".join(parts)


def leaf_groups(names) -> dict[str, list[str]]:
    """The port's parameter names grouped by reference leaf, in the order
    the reference flattens its params (dict keys sorted at every level),
    a stack's layers ascending."""
    groups: dict[str, list[str]] = {}
    for name in names:
        groups.setdefault(leaf_path(name), []).append(name)
    for grp in groups.values():
        grp.sort(key=lambda n: int(n.split(".")[1]) if n.split(".")[0]
                 in _STACKS else 0)
    return {k: groups[k] for k in sorted(groups,
                                         key=lambda k: tuple(k.split("/")))}


def model_params_to_numpy(tree: dict) -> dict:
    """The inverse of :func:`model_params_from_numpy`: a port tree keyed by
    parameter name (a ``state_dict``, its gradients or moments) as the
    reference's flat ``{"layers/attn/wq": array}``, the layers stacked on a
    leading axis; bfloat16 as float32."""
    def n(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return {path: (np.stack([n(tree[m]) for m in grp])
                   if path.split("/")[0] in _STACKS else n(tree[grp[0]]))
            for path, grp in leaf_groups(tree).items()}
