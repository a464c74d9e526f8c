"""AdamW with warmup and cosine decay and global-norm clipping, the
counterpart of ``repro.train.optimizer``.

A tree here is a dict keyed by the model's parameter names
(``dict(model.named_parameters())``); the moments ``m`` and ``v`` are trees
congruent with it, in ``opt_dtype``. The reference stacks each layer stack's
leaves on one axis, so where it reduces over its leaves (the global norm)
the port adds its per-layer tensors up per reference leaf
(``convert.leaf_groups``) and the leaves in the reference's order.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.convert import leaf_groups

_F32 = torch.float32


class OptState(NamedTuple):
    step: torch.Tensor        # int32 scalar: updates taken
    m: dict
    v: dict


def init_opt_state(params: dict, opt_dtype: str = "float32") -> OptState:
    """Zero moments in ``opt_dtype`` beside each parameter, step 0."""
    dt = getattr(torch, opt_dtype)
    dev = next(iter(params.values())).device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m={k: torch.zeros(p.shape, dtype=dt, device=p.device)
           for k, p in params.items()},
        v={k: torch.zeros(p.shape, dtype=dt, device=p.device)
           for k, p in params.items()})


def lr_schedule(step: torch.Tensor, tc: TrainConfig,
                total_steps: int = 10_000) -> torch.Tensor:
    """Linear warmup over ``warmup_steps``, then cosine decay to a floor of
    0.1 of ``learning_rate`` at ``total_steps``; float32, on step's
    device."""
    s = step.to(_F32)
    warm = torch.clamp(s / max(tc.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - tc.warmup_steps)
                       / max(total_steps - tc.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return tc.learning_rate * warm * (0.1 + 0.9 * cos)


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the float32 squares summed: each reference leaf's sum (its
    layers' together), the leaves added one after another in the
    reference's leaf order."""
    sq = None
    for grp in leaf_groups(tree).values():
        parts = [torch.sum(torch.square(tree[n].float())) for n in grp]
        leaf = parts[0] if len(parts) == 1 else torch.stack(parts).sum()
        sq = leaf if sq is None else sq + leaf
    return torch.sqrt(sq)


@torch.no_grad()
def adamw_update(params: dict, grads: dict, opt: OptState, tc: TrainConfig,
                 total_steps: int = 10_000):
    """One AdamW step with the gradients clipped to a global norm of
    ``grad_clip``; the math in float32, each parameter cast back to its
    dtype. Updates ``params`` and the moments in place and returns
    (params, OptState, {"grad_norm", "lr"})."""
    step = opt.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(tc.grad_clip / torch.clamp_min(gnorm, 1e-9), max=1.0)
    lr = lr_schedule(step, tc, total_steps)
    sf = step.to(_F32)
    b1c = 1.0 - torch.pow(torch.tensor(tc.b1, dtype=_F32, device=sf.device),
                          sf)
    b2c = 1.0 - torch.pow(torch.tensor(tc.b2, dtype=_F32, device=sf.device),
                          sf)
    for k, p in params.items():
        g = grads[k].float() * scale
        m2 = tc.b1 * opt.m[k].float() + (1.0 - tc.b1) * g
        v2 = tc.b2 * opt.v[k].float() + (1.0 - tc.b2) * torch.square(g)
        delta = (m2 / b1c) / (torch.sqrt(v2 / b2c) + tc.eps) \
            + tc.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        opt.m[k].copy_(m2)
        opt.v[k].copy_(v2)
    return params, OptState(step, opt.m, opt.v), {"grad_norm": gnorm,
                                                  "lr": lr}
