"""Device dispatch for the Hopper kernels.

A CPU tensor takes the plain PyTorch version (``ref``); a CUDA tensor takes
the hand-written kernel (``event_select``, ``bandwidth_share``,
``flash_attention``, ``rwkv6_scan``/``ssm_scan``), which raises on anything
it does not accept. There is no fallback from the kernel to the plain
version. A ``meta`` tensor (the dry run's, ``roofline/count.py``) takes the
plain version too: it holds no data, so nothing is computed and nothing is
hidden, and the dry run counts the products of a step without a card. A
tensor on any other device raises. The engine's ``select_fn``/
``group_fn``/``trace_fn``/``route_fn`` hooks default to these functions,
``spec.fused_select`` binds ``fused_fn`` and ``slot_fn`` to
``fused_select`` and ``ring_slots``, the flow handlers'
``core.network.maxmin_rates`` calls ``maxmin_rates``, and the model zoo's
prefill (and whisper's encoder and cross-attention) calls
``flash_attention`` (``models/layers.py``) and ``rwkv6_scan``
and ``ssd_scan`` (``models/linear_rnn.py``), so on the card the main paths
run the kernels.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.kernels import bandwidth_share as _bs
from repro_torch.kernels import event_select as _es
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rwkv6_scan as _gla
from repro_torch.kernels import ssm_scan as _ssd

I32 = torch.int32

# Replicas stacked on the lanes of a handler call (``Engine.run_ensemble``).
# The reference's replica vmap leaves the one-lane flow-sum order of a
# replica as it is in a run of its own, so ``maxmin_rates`` takes the order
# of the lanes of one replica.
_lane_groups = contextvars.ContextVar("lane_groups", default=1)


@contextlib.contextmanager
def lane_groups(n: int):
    """Within the block, a call's B lanes are ``n`` replicas of B / n."""
    token = _lane_groups.set(int(n))
    try:
        yield
    finally:
        _lane_groups.reset(token)


def _on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU or meta tensor
    (the plain version); any other device raises."""
    if x.is_cuda:
        return True
    if x.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"no kernel or plain version for device {x.device}")


def _i32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a contiguous int32 tensor; ``x`` itself (no dispatcher call)
    when it is one already, as the engine's tensors are."""
    if x.dtype == I32 and x.is_contiguous():
        return x
    return x.to(I32).contiguous()


def _bool(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a contiguous bool tensor (itself when it is one)."""
    if x.dtype == torch.bool and x.is_contiguous():
        return x
    return x.bool().contiguous()


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
    """(A, m) kinds + active mask -> (order, rank, counts). On the card an
    int32, bool or uint8 mask (the engine's bool ``clean``) goes to the
    kernel as it is."""
    if _on_card(kind):
        if active.dtype not in _es.MASK_BYTES:
            active = active.to(I32)
        if not active.is_contiguous():
            active = active.contiguous()
        return _es.group_by_kind(_i32(kind), active, n_kinds)
    return _ref.group_by_kind(kind, active, n_kinds)


def trace_rank(mask):
    """(A, n) processed mask -> (A, n) exclusive prefix ranks. On the card
    an int32, bool or uint8 mask (the engine's bool ``exec_safe``) goes to
    the kernel as it is."""
    if _on_card(mask):
        if mask.dtype not in _es.MASK_BYTES:
            mask = mask.to(I32)
        return _es.trace_rank(mask.contiguous())
    return _ref.trace_rank(mask)


def route_rank(dst_agent, n_buckets: int):
    """(A, n) destination buckets in [0, n_buckets) -> stable ranks."""
    if _on_card(dst_agent):
        return _es.route_rank(_i32(dst_agent), n_buckets)
    return _ref.route_rank(dst_agent)


def ring_slots(free_ring, head, want):
    """(A, cap) free ring, (A,) head, (A, n) insert mask -> (A, n) slots."""
    if _on_card(free_ring):
        return _es.ring_slots(_i32(free_ring), _i32(head), _bool(want))
    return _ref.ring_slots(free_ring, head, want)


def fused_select(time_key, seq, safe, time, kind, src, dst, ctx, payload,
                 valid, table_id, res, free_tail, exec_cap: int, *,
                 n_kinds: int, n_res: int):
    """(A, cap) pool columns -> the window front end's ``FusedSelect`` and
    the clean lanes' per-kind counts."""
    kw = dict(n_kinds=n_kinds, n_res=n_res)
    if _on_card(time_key):
        return _es.fused_select(
            *map(_i32, (time_key, seq)), _bool(safe),
            *map(_i32, (time, kind, src, dst, ctx)),
            payload.float().contiguous(), _bool(valid),
            *map(_i32, (table_id, res, free_tail)), exec_cap, **kw)
    return _ref.fused_select(time_key, seq, safe, time, kind, src, dst, ctx,
                             payload, valid, table_id, res, free_tail,
                             exec_cap, **kw)


def maxmin_rates(inc, bw, active):
    """(B, F, L) 0/1 incidence, (B, L) capacities, (B, F) active -> (B, F)
    max-min fair rates, the flows summed in ``ref.flow_order`` of the lanes
    of one replica (``lane_groups``)."""
    B, F, L = inc.shape
    order = _ref.flow_order(F, L, B // _lane_groups.get())
    if _on_card(inc):
        return _bs.maxmin_rates(inc.float().contiguous(),
                                bw.float().contiguous(),
                                active.bool().contiguous(), order)
    return _ref.maxmin_rates(inc, bw, active, order)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q (BH, Sq, D), k and v (BKV, Skv, D) -> (BH, Sq, D) causal,
    sliding-window or (``causal=False``) full attention, KV row bh // (BH
    // BKV) for query row bh."""
    if _on_card(q):
        return _fa.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal,
                                   window=window)
    return _ref.attention(q, k, v, causal=causal, window=window)


def _tile_heads(u, bh: int):
    """(H, dk) per-head rows -> (BH, dk) for rows b * H + h."""
    if bh % u.shape[0]:
        raise ValueError(f"{u.shape[0]} heads do not tile {bh} rows")
    return u.repeat(bh // u.shape[0], 1)


def rwkv6_scan(q, k, v, w, u, *, chunk: int = 64):
    """RWKV6 chunked GLA from the zero state: q, k, w (BH, S, dk), v (BH, S,
    dv), bonus u (H, dk) for rows b * H + h (H = BH: one row each) ->
    (out (BH, S, dv), state (BH, dk, dv) float32)."""
    u = _tile_heads(u, q.shape[0])
    if _on_card(q):
        return _gla.gla_scan(q.contiguous(), k.contiguous(), v.contiguous(),
                             w.float().contiguous(), u.float().contiguous(),
                             mode="k", chunk=chunk)
    return _ref.gla_scan(q, k, v, w, u, mode="k", chunk=chunk)


def ssd_scan(q, k, v, w, *, chunk: int = 64):
    """SSD chunked scan from the zero state: q = C, k = B (BH, S, dk), v and
    the decays w (BH, S, dv) -> (out (BH, S, dv), state (BH, dk, dv))."""
    if _on_card(q):
        return _ssd.ssd_scan(q.contiguous(), k.contiguous(), v.contiguous(),
                             w.float().contiguous(), chunk=chunk)
    return _ref.gla_scan(q, k, v, w, mode="v", chunk=chunk)
