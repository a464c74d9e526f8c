"""The scheduling algorithm of the paper's §4.1 (counterpart of
``repro.core.scheduler``): monitoring-driven placement of LPs on agents.

Each agent publishes a performance value (workstation, network and agent
load). For a new simulation job the scheduler builds a complete graph over
the agents with edge weight the mean of the endpoints' values, takes all
shortest paths, and scores each candidate by its mean shortest-path cost to
the agents already in the run; the lowest score wins, so the LPs of one run
cluster. All-pairs shortest paths are min-plus matrix squaring.

The scores equal the reference's bit for bit: the float32 sums over agents
run in XLA:CPU's order (``sum_chunks``: left to right up to 32 agents, then
in chunks, as ``tools/probe_sum_order.py`` reads it at 33-512 agents), and
the mean is the sum times the float32 reciprocal of the count, as XLA
computes it.
Placements are int32 and equal. Component state is replicated, so a
migration only rewrites ``lp_agent`` and re-homes pending events
(``Engine.apply_placement_local``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import monitoring as mon

F32 = torch.float32


# the largest agent count whose sum order was probed; beyond it the sums
# run left to right (ROADMAP.md, section 3)
PROBED_AGENTS = 512


def sum_chunks(n: int) -> list[int]:
    """XLA:CPU's partition of a float32 sum over ``n`` values (jax 0.9.0,
    read at every n = 33-512 by ``tools/probe_sum_order.py``; the same for
    ``jnp.sum``, ``jnp.mean`` and the row sums of an (n, n) matrix, op by op
    or jitted): up to 32 values one chunk; else ``ceil(n / 32)`` chunks,
    the inner ones of 32, the rest split between the two ends, the first
    taking the odd one. Each chunk sums left to right, and so do the chunk
    totals. Beyond ``PROBED_AGENTS``: one chunk."""
    k = -(-n // 32)
    if k <= 1 or n > PROBED_AGENTS:
        return [n]
    r = n - 32 * (k - 2)
    return [r - r // 2] + [32] * (k - 2) + [r // 2]


def _sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in float32, in XLA:CPU's order
    (``sum_chunks``)."""
    total = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    lo = 0
    for n in sum_chunks(x.shape[-1]):
        acc = torch.zeros_like(total)
        for k in range(lo, lo + n):
            acc = acc + x[..., k]
        total, lo = total + acc, lo + n
    return total


def performance_graph(perf: torch.Tensor,
                      link_cost: torch.Tensor | None = None) -> torch.Tensor:
    """(A,) performance values -> (A, A) complete weighted graph, edge
    weight ``(p_i + p_j) / 2`` (plus a measured link cost), diagonal 0."""
    w = 0.5 * (perf[:, None] + perf[None, :])
    if link_cost is not None:
        w = w + link_cost
    eye = torch.eye(perf.shape[0], dtype=w.dtype, device=w.device)
    return w * (1.0 - eye)


def apsp(w: torch.Tensor) -> torch.Tensor:
    """All-pairs shortest paths by min-plus matrix squaring."""
    a = w.shape[0]
    d = w
    n_iters = max(math.ceil(math.log2(max(a - 1, 2))), 1)
    for _ in range(n_iters):
        d = torch.amin(d[:, :, None] + d[None, :, :], dim=1)
    return d


def placement_scores(dist: torch.Tensor, participating: torch.Tensor,
                     perf: torch.Tensor) -> torch.Tensor:
    """(A,) mean shortest-path cost to the participating agents (the
    paper's final value); the raw performance value when none
    participates yet."""
    p = participating.to(dist.dtype)
    n = _sum_last(p)
    mean_to_part = _sum_last(dist * p[None, :]) / torch.clamp(n, min=1.0)
    return torch.where(n > 0, mean_to_part, perf)


def choose_agent(perf: torch.Tensor, participating: torch.Tensor,
                 link_cost: torch.Tensor | None = None) -> torch.Tensor:
    """The paper's §4.1 decision: the preferred agent (int32; the first of
    tied scores) for the next simulation job."""
    d = apsp(performance_graph(perf, link_cost))
    return torch.argmin(placement_scores(d, participating, perf)).to(
        torch.int32)


def perf_values_from_counters(fleet_counters: torch.Tensor,
                              n_owned: torch.Tensor,
                              pool_occ: torch.Tensor) -> torch.Tensor:
    """(A, n), (A,), (A,) -> (A,) published performance values."""
    return mon.performance_value(fleet_counters, n_owned, pool_occ)


def plan_placement(perf: torch.Tensor, lp_ctx: torch.Tensor, n_agents: int,
                   link_cost: torch.Tensor | None = None,
                   load_weight: float = 3.0) -> torch.Tensor:
    """Place every LP with the paper's algorithm, greedily, in ascending LP
    order: the participating set grows per context, so the LPs of one run
    cluster, and each placement adds ``load_weight`` to its agent's value
    (the monitoring feedback, compressed to one pass). A host loop over the
    LPs (the reference's ``lax.scan``); no host read but ``lp_ctx``."""
    ctxs = lp_ctx.tolist()
    n_ctx = max(ctxs) + 1 if ctxs else 1
    dev = perf.device
    perf_now = perf.to(F32)
    part = torch.zeros((n_ctx, n_agents), dtype=torch.bool, device=dev)
    bump = torch.full((1,), load_weight, dtype=F32, device=dev)
    placement = []
    for ctx in ctxs:
        agent = choose_agent(perf_now, part[ctx], link_cost).reshape(1)
        part[ctx] = part[ctx].index_fill(0, agent.long(), True)
        perf_now = perf_now.index_add(0, agent.long(), bump)
        placement.append(agent)
    if not placement:
        return torch.zeros((0,), dtype=torch.int32, device=dev)
    return torch.cat(placement)


def rebalance(fleet_counters: torch.Tensor, lp_agent: torch.Tensor,
              lp_ctx: torch.Tensor, pool_occ: torch.Tensor,
              threshold: float = 2.0) -> torch.Tensor:
    """Dynamic re-decomposition (paper §4): if the worst agent's value
    exceeds ``threshold`` times the mean, a fresh full placement, else the
    current one."""
    a = fleet_counters.shape[0]
    n_owned = torch.bincount(lp_agent.long(), minlength=a).to(torch.int32)
    perf = perf_values_from_counters(fleet_counters, n_owned, pool_occ)
    # XLA computes the mean as the sum times the float32 reciprocal
    mean = _sum_last(perf) * float(np.float32(1.0) / np.float32(a))
    hot = torch.amax(perf) > threshold * torch.clamp(mean, min=1e-6)
    fresh = plan_placement(perf, lp_ctx, a)
    return torch.where(hot, fresh, lp_agent.to(torch.int32))
