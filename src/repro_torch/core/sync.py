"""Conservative synchronization (paper §4.3), counterpart of
``repro.core.sync``.

The reference's ``pmin`` over the agent axis is an ``amin`` over the leading
agent dimension here; every result keeps that dimension, (A, ...).
``conflict_mask`` is the intra-window safety analysis of the batched
dispatch: two safe rows conflict iff they declare the same (component table,
resource row) under the handlers' delta contract.
"""
from __future__ import annotations

import torch

from repro_torch.core import events as ev
from repro_torch.core import tensor_util as tu


def local_min_per_ctx(pool: ev.EventPool, n_ctx: int) -> torch.Tensor:
    """(A, n_ctx) minimum pending timestamp per agent and context."""
    return ev.min_pending_time_per_ctx(pool, n_ctx)


def global_min(x: torch.Tensor, n_groups: int = 1) -> torch.Tensor:
    """Min over the agent dimension, broadcast back to every agent — the
    collective null-message exchange. ``n_groups`` splits the rows into that
    many equal runs (an ensemble's replicas, each its own fleet of agents)
    and takes the min within each."""
    g = x.reshape((n_groups, -1) + x.shape[1:])
    return torch.amin(g, dim=1, keepdim=True).expand_as(g).reshape(x.shape)


def horizons(gvt: torch.Tensor, lookahead: int, t_end: int) -> torch.Tensor:
    """Per-context safe horizon: every event strictly below it may execute."""
    h = torch.where(gvt < ev.T_INF - lookahead, gvt + lookahead, ev.T_INF)
    return torch.clamp_max(h, t_end)


def all_done(gvt: torch.Tensor, t_end: int) -> torch.Tensor:
    """(A,) True when every context has drained or passed the horizon."""
    return torch.all((gvt >= t_end) | (gvt == ev.T_INF), dim=-1)


def safe_mask(pool: ev.EventPool, horizon_per_ctx: torch.Tensor
              ) -> torch.Tensor:
    """Events allowed to execute in this conservative window."""
    h = torch.gather(horizon_per_ctx, 1,
                     pool.ctx.clamp(0, horizon_per_ctx.shape[1] - 1).long())
    return pool.valid & (pool.time < h)


def _dup_mask(key: torch.Tensor, active: torch.Tensor, n_keys: int
              ) -> torch.Tensor:
    """True where ``key`` occurs more than once among ``active`` rows of the
    same agent. Inactive rows get per-row unique sentinels (>= n_keys)."""
    A, n = key.shape
    pos = tu.arange(n, key.device)[None]
    k = torch.where(active, key, n_keys + pos)
    ks, order = torch.sort(k, dim=1)
    eq = ks[:, 1:] == ks[:, :-1]
    pad = torch.zeros((A, 1), dtype=torch.bool, device=key.device)
    dup_sorted = torch.cat([pad, eq], 1) | torch.cat([eq, pad], 1)
    return torch.zeros_like(active).scatter(1, order, dup_sorted)


def conflict_mask(safe: torch.Tensor, table_id: torch.Tensor,
                  res: torch.Tensor, *, n_res: int, n_tables: int
                  ) -> torch.Tensor:
    """Rows of a window whose handler writes may overlap another safe row's.

    Rows with ``table_id == 0`` (kinds that declare no component row) never
    conflict. Conflict-free rows execute in one batched dispatch; conflicted
    rows take the engine's sequential fallback."""
    rkey = table_id * n_res + res
    comp = safe & (table_id > 0)
    return safe & _dup_mask(rkey, comp, n_tables * n_res)


def exec_selection_ring(safe: torch.Tensor, exec_idx: torch.Tensor
                        ) -> torch.Tensor:
    """Execution flags of the compacted candidates (safe slots beyond
    exec_cap stay in the pool and spill to the next window)."""
    return torch.gather(safe, 1, exec_idx.long())


def exec_selection(safe: torch.Tensor, exec_idx: torch.Tensor):
    """``(slot_mask, exec_safe)``: the pool slots executed this window and
    the execution flags of the compacted candidates (the reclaim mask of
    ``insert_mode="ref"``). ``exec_idx`` holds distinct slots per agent."""
    exec_safe = exec_selection_ring(safe, exec_idx)
    slot_mask = torch.zeros_like(safe).scatter(1, exec_idx.long(), exec_safe)
    return slot_mask, exec_safe
