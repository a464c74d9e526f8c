"""Interrupt-based network traffic model (paper §4.2), counterpart of
``repro.core.network``.

Every function works over a leading lane dimension. The float arithmetic
follows the reference bit for bit on the CPU and on the card:

* the per-link sum of frozen rates (``inc.T @ (rate * frozen)`` in the
  reference) is a sum of explicit additions in XLA:CPU's order, never a
  BLAS call or ``torch.sum``, whose orders differ between devices. Where the
  reference is batched (vmapped over several lanes) XLA sums left to right
  over flows. Where it runs on one lane it sums in an order that depends on
  the flow count (:func:`_sum_flows`): the oracle's single-event step and,
  with one agent, the engine's conflict fallback, its sequential fold and a
  one-row window (XLA drops a vmap of size 1). The port's handlers see the
  same lane counts, so one lane here is the reference's unbatched context;
* ``rem - rate * dt`` is one fused multiply-add in the reference;
  ``tensor_util.fms`` rounds it once;
* float -> int conversions saturate as XLA's do (``tensor_util.f2i``).
"""
from __future__ import annotations

import torch

from repro_torch.core import events as ev
from repro_torch.core import tensor_util as tu

_EPS = 1e-6
_BIG = 3.0e38

# XLA:CPU's order for an unbatched ``inc.T @ x`` over F flows, found by
# probing its compiled matvec (tests/test_torch_network.py):
# F -> (V, order): eight lane accumulators over the first V flows, lane l
# adding flows 8 * b + l for b in ``order``, the lanes summed by halves
# ((l, l + 4), then (l, l + 2), then (0, 1)), then flows V.. left to right.
# Up to 49 flows the sum is left to right; other F are not reproduced
# (ROADMAP.md, reference caveats) and sum left to right.
_ORDER_48 = (48, (0, 2, 4, 3, 1, 5))
_ORDER_64 = (64, (0, 4, 5, 1, 6, 2, 7, 3))
_UNBATCHED_ORDER = {
    **dict.fromkeys((50, 51, 52, 56, 64), _ORDER_48),
    **dict.fromkeys((65, 66, 67, 68, 72, 96), _ORDER_64),
    128: (96, (0, 4, 8, 5, 1, 9, 6, 2, 10, 7, 3, 11)),
}


def _sum_flows(contrib: torch.Tensor) -> torch.Tensor:
    """(F, B, L) -> (B, L): the sum over flows in the reference's order for
    B lanes: ``_UNBATCHED_ORDER`` on one lane, else left to right."""
    F, B = contrib.shape[:2]
    V, order = (_UNBATCHED_ORDER.get(F, (0, ())) if B == 1 else (0, ()))
    if V:
        blocks = contrib[:V].reshape((V // 8, 8) + contrib.shape[1:])
        acc = blocks[order[0]]
        for b in order[1:]:
            acc = acc + blocks[b]
        while acc.shape[0] > 1:
            h = acc.shape[0] // 2
            acc = acc[:h] + acc[h:]
        acc = acc[0]
    else:
        acc = contrib[0]
        V = 1
    for f in range(V, F):
        acc = acc + contrib[f]
    return acc


def incidence(flow_links: torch.Tensor, n_links: int) -> torch.Tensor:
    """(..., F, MAXHOP) routes -> (..., F, L) 0/1 float incidence."""
    lk = torch.arange(n_links, dtype=torch.int32, device=flow_links.device)
    hops = flow_links[..., None] == lk
    return torch.any(hops, dim=-2).to(torch.float32)


def maxmin_rates(inc: torch.Tensor, bw: torch.Tensor, active: torch.Tensor
                 ) -> torch.Tensor:
    """Progressive-filling max-min fair rates over lanes.

    inc: (B, F, L) 0/1, bw: (B, L), active: (B, F) bool -> (B, F) rates.
    L rounds, each freezing every flow that crosses a bottleneck link."""
    B, F, L = inc.shape
    inc = inc * active[..., None].to(inc.dtype)
    big = torch.full((), _BIG, dtype=torch.float32, device=inc.device)
    rate = torch.zeros((B, F), dtype=torch.float32, device=inc.device)
    frozen = ~active
    for _ in range(L):
        unfrozen = active & ~frozen
        # integer-valued counts: exact in any summation order
        n_unf = torch.sum(inc * unfrozen[..., None].to(torch.float32), dim=1)
        contrib = (inc * (rate * frozen.to(torch.float32))[..., None]
                   ).transpose(0, 1).contiguous()          # (F, B, L)
        used = _sum_flows(contrib)
        resid = torch.clamp_min(bw - used, 0.0)
        fair = torch.where(n_unf > 0, resid / torch.clamp_min(n_unf, 1.0), big)
        fair = torch.where((bw <= 0) & (n_unf > 0), 0.0, fair)
        level = torch.amin(fair, dim=1, keepdim=True)
        bottleneck = fair <= level + _EPS
        hits = torch.any((inc > 0) & bottleneck[:, None, :], dim=2)
        newly = unfrozen & hits
        rate = torch.where(newly, level, rate)
        frozen = frozen | newly
    return torch.where(active, rate, 0.0)


def progress_flows(rem, rate, tlast, active, now):
    """Advance all active flows of a region row to virtual time ``now``."""
    dt = torch.clamp_min(now[:, None] - tlast, 0).to(torch.float32)
    rem2 = torch.where(active, torch.clamp_min(tu.fms(rem, rate, dt), 0.0),
                       rem)
    tlast2 = torch.where(active, now[:, None], tlast)
    return rem2, tlast2


def completion_times(rem, rate, tlast, active):
    """(B, F) predicted completion tick per flow (T_INF when idle/starved)."""
    ticks = torch.where(rate > _EPS,
                        torch.ceil(rem / torch.clamp_min(rate, _EPS)), _BIG)
    t_fin = tlast.to(torch.float32) + torch.clamp_min(ticks, 1.0)
    t_fin = torch.where(active, t_fin, _BIG)
    return tu.f2i(torch.clamp_max(t_fin, float(ev.T_INF)))


def route_latency(flow_links_row: torch.Tensor, link_lat: torch.Tensor
                  ) -> torch.Tensor:
    """Total propagation latency of each lane's route (sum over real hops)."""
    valid = flow_links_row >= 0
    lat = torch.gather(link_lat, -1,
                       flow_links_row.clamp(0, link_lat.shape[-1] - 1).long())
    return tu.isum(torch.where(valid, lat, 0), -1)
