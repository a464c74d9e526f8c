"""Plain PyTorch versions of the window front-end kernels.

Counterparts of ``repro.kernels.ref`` and of the XLA twins in
``repro.core.engine`` (``select_events_xla``, ``group_by_kind_xla``,
``route_rank_xla``). Every function works row-wise over a leading agent
dimension: inputs are (A, n). These serve CPU tensors and are what
``chip_smoke.py`` holds the CUDA kernels against on the card.
"""
from __future__ import annotations

import torch

I32 = torch.int32


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
