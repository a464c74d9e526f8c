"""Logical-axis sharding rules, the counterpart of
``repro.models.sharding`` (MaxText-style, with divisibility-aware
fallbacks).

Every parameter of the model zoo carries a tuple of logical axis names
(``Model.param_names``). A ``Rules`` mapping takes each logical name to an
ordered list of mesh-axis candidates; the first candidate whose mesh-axis
product divides the dimension (and whose mesh axes are not already taken by
an earlier dim of the same tensor) wins. One rule set serves every
architecture: 25-head models fall back to unsharded heads while their MLPs
stay tensor-parallel.

The port partitions nothing: a mesh here is a dict of axis sizes, and a
placement is a plain tuple with one entry per dim (a mesh axis, a tuple of
axes, or None) in place of a ``PartitionSpec``. The dry run reads the
placements for the per-device bytes of each leaf (``roofline/analysis.py``).
The reference's ``constrain``, ``shard`` and ``sharding_ctx`` (the
``with_sharding_constraint`` hooks of its model code) have no counterpart.
"""
from __future__ import annotations

import math
from typing import Mapping, Sequence

# logical name -> ordered candidates; each candidate is a tuple of mesh axes
Rules = Mapping[str, Sequence[tuple[str, ...]]]
Spec = tuple

DEFAULT_RULES: dict[str, tuple[tuple[str, ...], ...]] = {
    # activations
    "batch": (("pod", "data"), ("data",), ("pod",)),
    "seq": (),                      # unsharded by default (full activations)
    "act_seq": (("model",),),       # sequence-sharded saved activations / norms
    "embed": (),
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "head": (),
    "mlp": (("model",),),
    "experts": (("model",),),
    "expert_cap": (),
    "vocab": (("model",),),
    "seq_kv": (("model",),),        # decode KV-cache fallback axis
    # weights
    "fsdp": (("data",),),           # ZeRO-3 weight axis
    "layers": (),                   # scan axis
    "ssm_state": (),
    "conv": (),
}


def spec_for(shape: Sequence[int], names: Sequence[str], rules: Rules,
             mesh_shape: Mapping[str, int]) -> Spec:
    """Resolve logical names to a placement for a concrete shape and mesh:
    one entry per dim, a mesh axis, a tuple of axes or None."""
    assert len(shape) == len(names), (shape, names)
    used: set[str] = set()
    parts = []
    for dim, name in zip(shape, names):
        pick = None
        for cand in rules.get(name, ()):
            if any(a in used or a not in mesh_shape for a in cand):
                continue
            prod = math.prod(mesh_shape[a] for a in cand)
            if dim > 0 and dim % prod == 0 and prod > 1:
                pick = cand
                break
        if pick is None:
            parts.append(None)
        else:
            used.update(pick)
            parts.append(pick[0] if len(pick) == 1 else pick)
    return tuple(parts)


def spec_axes(spec: Spec) -> tuple[str, ...]:
    """The mesh axes a placement shards over, in dim order."""
    out = []
    for part in spec:
        if part is not None:
            out += [part] if isinstance(part, str) else list(part)
    return tuple(out)


def shard_shape(shape: Sequence[int], spec: Spec,
                mesh_shape: Mapping[str, int]) -> tuple[int, ...]:
    """One device's block of a tensor of ``shape`` placed by ``spec``."""
    return tuple(d // math.prod(mesh_shape[a] for a in spec_axes((p,)))
                 for d, p in zip(shape, spec))


def param_specs(model, rules: Rules, mesh_shape: Mapping[str, int]) -> dict:
    """{tree path: placement} of every leaf of ``model.leaves()`` (the
    counterpart of the reference's ``tree_specs``)."""
    return {k: spec_for(shape, names, rules, mesh_shape)
            for k, (shape, _, names) in model.leaves().items()}
