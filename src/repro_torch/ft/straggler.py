"""Straggler detection and mitigation, the counterpart of
``repro.ft.straggler``: the paper's scheduler as a fleet feature.

A gang-scheduled training step takes as long as its slowest host, as a
simulation job waits for its slowest workstation (the paper's section 4.1).
Detection: a per-host EWMA of step wall time; a host whose EWMA exceeds
``threshold`` times the fleet median is flagged. Mitigation: the measured
slowness becomes the agents' performance values, and the paper's placement
(``core.scheduler.plan_placement``) moves DES LPs away from the slow host;
for the training fleet, an eviction recommendation for ``ft.elastic``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import scheduler as sched


@dataclasses.dataclass
class StragglerMonitor:
    n_hosts: int
    alpha: float = 0.2
    threshold: float = 1.5

    def __post_init__(self):
        self.ewma = np.zeros(self.n_hosts)
        self.count = np.zeros(self.n_hosts, dtype=int)

    def record(self, host: int, step: int, seconds: float):
        if self.count[host] == 0:
            self.ewma[host] = seconds
        else:
            self.ewma[host] = (1 - self.alpha) * self.ewma[host] \
                + self.alpha * seconds
        self.count[host] += 1

    def stragglers(self) -> list[int]:
        seen = self.count > 0
        if seen.sum() < 2:
            return []
        med = float(np.median(self.ewma[seen]))
        return [h for h in range(self.n_hosts)
                if seen[h] and self.ewma[h] > self.threshold * max(med, 1e-9)]

    def replacement_plan(self, lp_agent, lp_ctx, device="cpu"):
        """Re-place LPs with the paper's algorithm, the measured slowness
        folded into the performance values (slow agents look expensive):
        (n_lps,) int32 agents on ``device``."""
        perf = torch.as_tensor(
            np.where(self.count > 0, self.ewma,
                     self.ewma.mean() if self.count.any() else 1.0),
            dtype=torch.float32, device=device)
        perf = perf / torch.clamp_min(torch.min(perf), 1e-9)
        return sched.plan_placement(perf * 10.0,
                                    torch.as_tensor(lp_ctx, device=device),
                                    self.n_hosts)

    def eviction_recommendation(self) -> dict:
        s = self.stragglers()
        return {"evict_hosts": s, "healthy": [h for h in range(self.n_hosts)
                                              if h not in s]}
