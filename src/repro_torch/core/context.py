"""Simulation contexts (paper §4.3; counterpart of ``repro.core.context``).

Every LP and event carries a context id; GVT, horizons and termination are
reduced per context, so simulation runs advance independently on one fleet
of agents. Isolation is structural: a handler touches only its destination
LP's resources, and an LP belongs to one context. These are the
bookkeeping helpers, over the port's stacked (A, ...) tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import events as ev


def _count(seg: torch.Tensor, weight: torch.Tensor, n_ctx: int):
    """Per-row counts of ``seg`` values in [0, n_ctx) over the last axis;
    other values are dropped."""
    seg = torch.where((seg >= 0) & (seg < n_ctx), seg, n_ctx).long()
    out = torch.zeros(seg.shape[:-1] + (n_ctx + 1,), dtype=torch.int32,
                      device=seg.device)
    return out.scatter_add(-1, seg, weight.to(torch.int32))[..., :n_ctx]


def ctx_event_counts(pool: ev.EventPool, n_ctx: int) -> torch.Tensor:
    """(A, n_ctx) pending events per context on each agent."""
    seg = torch.where(pool.valid, pool.ctx, n_ctx)
    return _count(seg, pool.valid, n_ctx)


def ctx_done(gvt: torch.Tensor, t_end: int) -> torch.Tensor:
    """(..., n_ctx) bool: which simulation runs have finished."""
    return (gvt >= t_end) | (gvt == ev.T_INF)


def ctx_lp_counts(world, n_ctx: int) -> torch.Tensor:
    """(..., n_ctx) LPs per context (the world is replicated, so each
    agent's row is the fleet's)."""
    return _count(world.lp_ctx, torch.ones_like(world.lp_ctx), n_ctx)


def validate_isolation(world) -> bool:
    """Host check: every resource row is referenced by LPs of one context
    (of the builder's world or of a stacked state's first row)."""
    def row(x):
        x = np.asarray(x.cpu())
        return x[0] if x.ndim == 2 else x

    lp_res, lp_kind, lp_ctx = (row(world.lp_res), row(world.lp_kind),
                               row(world.lp_ctx))
    seen: dict[tuple[int, int], int] = {}
    for lp in range(lp_res.shape[0]):
        key = (int(lp_kind[lp]), int(lp_res[lp]))
        c = int(lp_ctx[lp])
        if key in seen and seen[key] != c:
            return False
        seen[key] = c
    return True
