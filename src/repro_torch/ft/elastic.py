"""Elastic scaling: rebuild the mesh from the surviving hosts and re-shard
the state (the counterpart of ``repro.ft.elastic``, plain Python).

On a failure or a straggler's eviction: ``plan_remesh(n_alive)`` picks the
largest power-of-two (data, model) grid that fits the survivors, shrinking
the data axis first (the stateless data pipeline re-divides the batch for
free) and the model axis only below one model group; ``reshard_plan(old,
new)`` says per axis whether shards are kept, gathered or split; the
checkpointer restores the last committed step when the fleet restarts
cold.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    axes: tuple[str, ...]
    shape: tuple[int, ...]

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def plan_remesh(n_alive: int, *, model_parallel: int = 16,
                multi_pod: bool = False) -> MeshPlan:
    """Largest power-of-two mesh <= n_alive keeping the model axis intact.

    Shrinking `model` would re-layout every weight shard; shrinking `data` only
    changes the batch divisor, so data gives way first. If fewer than one model
    group survives, model halves (weights re-gathered from checkpoint shards).
    """
    assert n_alive >= 1
    mp = model_parallel
    while mp > n_alive:
        mp //= 2
    dp = 1
    while dp * 2 * mp <= n_alive:
        dp *= 2
    if multi_pod and dp % 2 == 0:
        return MeshPlan(("pod", "data", "model"), (2, dp // 2, mp))
    return MeshPlan(("data", "model"), (dp, mp))


def reshard_plan(old: MeshPlan, new: MeshPlan) -> dict:
    """Logical description of the state movement between meshes."""
    o = dict(zip(old.axes, old.shape))
    n = dict(zip(new.axes, new.shape))
    plan = {}
    for ax in ("pod", "data", "model"):
        a, b = o.get(ax, 1), n.get(ax, 1)
        if a == b:
            plan[ax] = "keep"
        elif a > b:
            plan[ax] = f"gather x{a // b}"     # fewer shards: all-gather groups
        else:
            plan[ax] = f"split x{b // a}"      # more shards: slice locally
    plan["batch_divisor"] = n.get("pod", 1) * n.get("data", 1)
    return plan


def validate_plan(plan: MeshPlan, n_alive: int) -> bool:
    return 1 <= plan.n_devices <= n_alive
