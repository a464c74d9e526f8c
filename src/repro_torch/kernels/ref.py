"""Plain PyTorch versions of the window front-end kernels.

Counterparts of ``repro.kernels.ref`` and of the XLA twins in
``repro.core.engine`` (``select_events_xla``, ``group_by_kind_xla``,
``route_rank_xla``), plus the free-ring ``ring_slots`` and the fused window
front end ``fused_select``. Every function works row-wise over a leading agent
dimension: inputs are (A, n). These serve CPU tensors and are what
``chip_smoke.py`` holds the CUDA kernels against on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

I32 = torch.int32


class FusedSelect(NamedTuple):
    """The window front end's result, every field window-aligned over the
    ``m = max(min(exec_cap, cap), 1)`` lanes of each agent: the selected
    slots in (time, seq) order and their safe flags, their gathered fields
    (raw on lanes that are not safe), the conflict-free lanes, the
    same-kind grouping permutation of the clean lanes and each lane's
    free-ring release position (meaningful on safe lanes)."""

    exec_idx: torch.Tensor   # (A, m) i32 pool slots
    exec_safe: torch.Tensor  # (A, m) bool
    time: torch.Tensor       # (A, m) i32 gathered event fields ...
    seq: torch.Tensor
    kind: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor
    ctx: torch.Tensor
    payload: torch.Tensor    # (A, m, PAYLOAD) f32
    valid: torch.Tensor      # (A, m) bool
    clean: torch.Tensor      # (A, m) bool: safe and conflict-free
    order: torch.Tensor      # (A, m) i32 grouping permutation
    rel_pos: torch.Tensor    # (A, m) i32 free-ring release position


def _argsort(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, dim=-1, stable=True).indices


def sort_events(time_key: torch.Tensor, seq: torch.Tensor) -> torch.Tensor:
    """(A, cap) -> (A, cap) permutation ascending by (time, seq), ties by
    slot index (two stable sorts, as ``lexsort_time_seq``)."""
    perm = _argsort(seq)
    perm2 = _argsort(torch.gather(time_key, -1, perm))
    return torch.gather(perm, -1, perm2).to(I32)


def select_events(time_key: torch.Tensor, seq: torch.Tensor,
                  exec_cap: int) -> torch.Tensor:
    """First ``min(exec_cap, cap)`` indices of the (time, seq) sort."""
    return sort_events(time_key, seq)[:, : min(exec_cap, time_key.shape[-1])]


def group_by_kind(kind: torch.Tensor, active: torch.Tensor, n_kinds: int):
    """Same-kind grouping ``(order, rank, counts)``: active rows first by
    ascending kind (clipped into range), stable in position, inactive rows
    last; ``rank`` aligned with ``order``; ``counts`` (A, n_kinds)."""
    key = torch.where(active.bool(), kind.clamp(0, n_kinds - 1), n_kinds)
    order = _argsort(key)
    ks = torch.gather(key, -1, order).contiguous()
    start = torch.searchsorted(ks, ks, side="left").to(I32)
    rank = torch.arange(ks.shape[-1], dtype=I32, device=ks.device) - start
    counts = torch.zeros(key.shape[:-1] + (n_kinds + 1,), dtype=I32,
                         device=key.device)
    counts = counts.scatter_add(-1, key.long(), torch.ones_like(key))
    return order.to(I32), rank, counts[..., :n_kinds]


def trace_rank(mask: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix count of the mask along the last dimension."""
    w = mask.to(I32)
    return torch.cumsum(w, dim=-1, dtype=I32) - w


def route_rank(dst_agent: torch.Tensor) -> torch.Tensor:
    """Stable within-bucket ranks for any int keys:
    ``rank[i] = |{j < i : dst_agent[j] == dst_agent[i]}|``."""
    sperm = _argsort(dst_agent)
    skey = torch.gather(dst_agent, -1, sperm).contiguous()
    group_start = torch.searchsorted(skey, skey, side="left").to(I32)
    rank_sorted = (torch.arange(skey.shape[-1], dtype=I32,
                                device=skey.device) - group_start)
    return torch.zeros_like(rank_sorted).scatter(-1, sperm, rank_sorted)


def ring_slots(free_ring: torch.Tensor, head: torch.Tensor,
               want: torch.Tensor) -> torch.Tensor:
    """Free-ring insert slots: ``free_ring[a, (head[a] + rank) % cap]`` with
    ``rank`` the exclusive prefix count of ``want`` (A, n)."""
    cap = free_ring.shape[-1]
    pos = (head.to(I32)[:, None] + trace_rank(want)) % cap
    return torch.gather(free_ring, -1, pos.long())


def fused_select(time_key, seq, safe, time, kind, src, dst, ctx, payload,
                 valid, table_id, res, free_tail, exec_cap: int, *,
                 n_kinds: int, n_res: int
                 ) -> tuple[FusedSelect, torch.Tensor]:
    """The window front end over (A, cap) pools: select the
    ``m = max(min(exec_cap, cap), 1)`` earliest slots, gather their fields,
    mark conflicts by a pairwise count on ``rkey = table_id * n_res + res``
    (rows with ``table_id == 0`` never conflict), group the clean lanes by
    kind, and rank the free-ring release ``(free_tail + rank) % cap``.
    Composed as ``repro.kernels.ref.fused_select_ref``. Returns the
    ``FusedSelect`` and the clean lanes' per-kind counts (A, n_kinds), as
    ``group_by_kind`` returns them."""
    cap = time_key.shape[-1]
    m = max(min(exec_cap, cap), 1)
    idx = select_events(time_key, seq, m)
    ix = idx.long()

    def g(x):
        return torch.gather(x, 1, ix)

    es = g(safe)
    tb = g(table_id)
    rkey = tb * n_res + g(res)
    comp = es & (tb > 0)
    cnt = ((rkey[:, :, None] == rkey[:, None, :])
           & comp[:, None, :]).sum(2)
    clean = es & ~(comp & (cnt >= 2))
    kind_w = g(kind)
    order, _rank, counts = group_by_kind(kind_w, clean, n_kinds)
    rel = (free_tail.to(I32)[:, None] + trace_rank(es)) % cap
    pay = torch.gather(payload, 1,
                       ix[..., None].expand(-1, -1, payload.shape[-1]))
    return FusedSelect(
        exec_idx=idx, exec_safe=es, time=g(time), seq=g(seq), kind=kind_w,
        src=g(src), dst=g(dst), ctx=g(ctx), payload=pay, valid=g(valid),
        clean=clean, order=order, rel_pos=rel), counts
