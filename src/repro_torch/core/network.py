"""Interrupt-based network traffic model (paper §4.2), counterpart of
``repro.core.network``.

Every function works over a leading lane dimension. The float arithmetic
follows the reference bit for bit on the CPU and on the card:

* the per-link sum of frozen rates in ``maxmin_rates`` (``inc.T @ (rate *
  frozen)`` in the reference) is a sum of explicit additions in XLA:CPU's
  order, in the kernel and in its plain version alike
  (``kernels.ref.flow_order``). Where the reference is batched (vmapped over
  several lanes) XLA sums left to right over flows. Where it runs on one lane
  it sums in an order that depends on the flow count: the oracle's
  single-event step and, with one agent, the engine's conflict fallback, its
  sequential fold and a one-row window (XLA drops a vmap of size 1). The
  port's handlers see the same lane counts, so one lane here is the
  reference's unbatched context;
* ``rem - rate * dt`` is one fused multiply-add in the reference;
  ``tensor_util.fms`` rounds it once;
* float -> int conversions saturate as XLA's do (``tensor_util.f2i``).
"""
from __future__ import annotations

import torch

from repro_torch.core import events as ev
from repro_torch.core import tensor_util as tu
from repro_torch.kernels import ops

_EPS = 1e-6
_BIG = 3.0e38


def incidence(flow_links: torch.Tensor, n_links: int) -> torch.Tensor:
    """(..., F, MAXHOP) routes -> (..., F, L) 0/1 float incidence."""
    lk = torch.arange(n_links, dtype=torch.int32, device=flow_links.device)
    hops = flow_links[..., None] == lk
    return torch.any(hops, dim=-2).to(torch.float32)


def maxmin_rates(inc: torch.Tensor, bw: torch.Tensor, active: torch.Tensor
                 ) -> torch.Tensor:
    """Progressive-filling max-min fair rates over lanes: inc (B, F, L) 0/1,
    bw (B, L), active (B, F) bool -> (B, F). The ``maxmin_rates`` kernel on
    the card, its plain version (``kernels.ref``) on the CPU."""
    return ops.maxmin_rates(inc, bw, active)


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
