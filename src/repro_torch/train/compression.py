"""Gradient compression: per-tensor symmetric int8 with error feedback, and
the int8 all-reduce over shards (the counterpart of
``repro.train.compression``).

Trees are dicts keyed by the model's parameter names. The reference
quantizes each of its leaves with one scale, and a layer stack is one leaf
there, so :func:`compress_tree` takes the scale of each reference leaf over
all of its layers (``convert.leaf_groups``); the round trip is then the
reference's bit for bit. ``torch.round``, as ``jnp.round``, rounds halves
to even.
"""
from __future__ import annotations

import torch

from repro_torch.convert import leaf_groups
from repro_torch.core.shards import ShardAxes

_F32 = torch.float32


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(amax / 127.0, 1e-12)


def _quantize(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor):
    """Per-tensor symmetric int8: returns (q int8, scale float32)."""
    xf = x.float()
    scale = _scale(torch.max(torch.abs(xf)))
    return _quantize(xf, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads: dict, error_fb: dict):
    """Quantize grads plus the carried error: returns ({name: (q, scale)},
    the new error tree grads + error - dequantized). The names of one
    reference leaf share its scale."""
    qtree, etree = {}, {}
    for grp in leaf_groups(grads).values():
        targets = {n: grads[n].float() + error_fb[n] for n in grp}
        scale = _scale(torch.stack([torch.max(torch.abs(t))
                                    for t in targets.values()]).max())
        for n, t in targets.items():
            q = _quantize(t, scale)
            qtree[n] = (q, scale)
            etree[n] = t - dequantize_int8(q, scale)
    return qtree, etree


def decompress_tree(qtree: dict) -> dict:
    return {n: dequantize_int8(q, scale) for n, (q, scale) in qtree.items()}


def init_error_fb(params: dict) -> dict:
    return {n: torch.zeros(p.shape, dtype=_F32, device=p.device)
            for n, p in params.items()}


def compressed_psum(xs: list, axes: ShardAxes) -> list:
    """The int8 all-reduce of one tensor a shard (``xs[s]`` on
    ``axes.devices[s]``): the max of the shards' absmax fixes one scale,
    each shard quantizes to int8, the int32 sum over shards (exact up to
    2**23 shards) is dequantized, and every shard gets the total."""
    d0 = axes.devices[0]
    scale = _scale(torch.stack([torch.max(torch.abs(x.float())).to(d0)
                                for x in xs]).max())
    total = None
    for x in xs:
        q = _quantize(x.float(), scale.to(x.device)).to(torch.int32).to(d0)
        total = q if total is None else total + q
    out = total.float() * scale
    return [out.to(d) for d in axes.devices]

