"""Device dispatch for the Hopper kernels.

A CPU tensor takes the plain PyTorch version (``ref``); a CUDA tensor takes
the hand-written kernel (``event_select``, ``bandwidth_share``), which raises
on anything it does not accept. There is no fallback from the kernel to the
plain version. The engine's ``select_fn``/``group_fn``/``trace_fn``/
``route_fn`` hooks default to these functions, ``spec.fused_select`` binds
``fused_fn`` and ``slot_fn`` to ``fused_select`` and ``ring_slots``, and the
flow handlers' ``core.network.maxmin_rates`` calls ``maxmin_rates``, so on
the card the main path runs the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bandwidth_share as _bs
from repro_torch.kernels import event_select as _es
from repro_torch.kernels import ref as _ref

I32 = torch.int32


def _on_card(x: torch.Tensor) -> bool:
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {x.device}")


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(I32).contiguous()


def select_events(time_key, seq, exec_cap: int):
    """(A, cap) -> (A, min(exec_cap, cap)) compacted gather indices."""
    if _on_card(time_key):
        return _es.select_events(_i32(time_key), _i32(seq), exec_cap)
    return _ref.select_events(time_key, seq, exec_cap)


def sort_events(time_key, seq):
    """(A, cap) -> (A, cap) permutation ascending by (time, seq)."""
    if _on_card(time_key):
        return _es.sort_events(_i32(time_key), _i32(seq))
    return _ref.sort_events(time_key, seq)


def group_by_kind(kind, active, n_kinds: int):
    """(A, m) kinds + active mask -> (order, rank, counts)."""
    if _on_card(kind):
        return _es.group_by_kind(_i32(kind), _i32(active), n_kinds)
    return _ref.group_by_kind(kind, active, n_kinds)


def trace_rank(mask):
    """(A, n) processed mask -> (A, n) exclusive prefix ranks."""
    if _on_card(mask):
        return _es.trace_rank(_i32(mask))
    return _ref.trace_rank(mask)


def route_rank(dst_agent, n_buckets: int):
    """(A, n) destination buckets in [0, n_buckets) -> stable ranks."""
    if _on_card(dst_agent):
        return _es.route_rank(_i32(dst_agent), n_buckets)
    return _ref.route_rank(dst_agent)


def ring_slots(free_ring, head, want):
    """(A, cap) free ring, (A,) head, (A, n) insert mask -> (A, n) slots."""
    if _on_card(free_ring):
        return _es.ring_slots(_i32(free_ring), _i32(head),
                              want.bool().contiguous())
    return _ref.ring_slots(free_ring, head, want)


def fused_select(time_key, seq, safe, time, kind, src, dst, ctx, payload,
                 valid, table_id, res, free_tail, exec_cap: int, *,
                 n_kinds: int, n_res: int):
    """(A, cap) pool columns -> the window front end's ``FusedSelect`` and
    the clean lanes' per-kind counts."""
    kw = dict(n_kinds=n_kinds, n_res=n_res)
    if _on_card(time_key):
        return _es.fused_select(
            *map(_i32, (time_key, seq)), safe.bool().contiguous(),
            *map(_i32, (time, kind, src, dst, ctx)),
            payload.float().contiguous(), valid.bool().contiguous(),
            *map(_i32, (table_id, res, free_tail)), exec_cap, **kw)
    return _ref.fused_select(time_key, seq, safe, time, kind, src, dst, ctx,
                             payload, valid, table_id, res, free_tail,
                             exec_cap, **kw)


def maxmin_rates(inc, bw, active):
    """(B, F, L) 0/1 incidence, (B, L) capacities, (B, F) active -> (B, F)
    max-min fair rates, the flows summed in ``ref.flow_order``."""
    if _on_card(inc):
        B, F, L = inc.shape
        return _bs.maxmin_rates(inc.float().contiguous(),
                                bw.float().contiguous(),
                                active.bool().contiguous(),
                                _ref.flow_order(F, L, B))
    return _ref.maxmin_rates(inc, bw, active)
