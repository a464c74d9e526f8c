"""Replica-cache / database-proxy LP, a component defined outside core
(counterpart of ``repro.scenarios.cache``).

A FIFO replica cache fronting a slow backend, the database-proxy pattern of
the paper's data-replication studies: one component table, two event kinds
with named payloads and two handlers, written lane-wise as in
``core/handlers.py``.

* ``CACHE_LOOKUP(key, size, notify_lp, notify_kind)`` probes the row's key
  set. A hit answers the requester after ``cache_hit_lat`` ticks; a miss
  sends a ``CACHE_FILL`` with the same payload to itself after
  ``cache_miss_lat`` ticks (the backend fetch).
* ``CACHE_FILL`` inserts the key at the FIFO cursor (evicting the oldest
  way), unless a racing fill inserted it first, then answers the requester.

Both handlers read and write exactly row ``lp_res[dst]`` of the ``cache``
table, so same-row lookups in one window serialise through the engine's
conflict fallback while distinct rows batch.
"""
from __future__ import annotations

import torch

from repro_torch.core import handlers as hd
from repro_torch.core import monitoring as mon
from repro_torch.core import tensor_util as tu
from repro_torch.core.components import BUILTIN, ScenarioBuilder
from repro_torch.core.registry import (FieldSpec, PayloadSpec, Registry,
                                       ScenarioBuilderBase)

i32 = torch.int32


def register_cache_model(reg: Registry) -> dict:
    """Declare the cache component, kinds, handlers and counters on ``reg``."""
    reg.dim("cache_ways", 8)
    c_lookups = reg.counter("CACHE_LOOKUPS",
                            "replica-cache membership probes served")
    c_fills = reg.counter("CACHE_FILLS",
                          "backend fetches that installed a replica")
    cache = reg.component("cache", doc="replica cache / database proxy", fields=dict(
        cache_hit_lat=FieldSpec((), i32, fill=1, doc="ticks to answer a hit"),
        cache_miss_lat=FieldSpec((), i32, fill=1, doc="ticks to fetch a replica from the backend"),
        cache_keys=FieldSpec(("cache_ways",), i32, mutable=True, fill=-1, doc="cached replica keys; -1 == empty way"),
        cache_ptr=FieldSpec((), i32, mutable=True, doc="FIFO eviction cursor"),
        cache_hits=FieldSpec((), i32, mutable=True, doc="lookup hits (per-row statistic)"),
        cache_miss=FieldSpec((), i32, mutable=True, doc="lookup misses (per-row statistic)"),
    ))
    payload = PayloadSpec("key", "size", ("notify_lp", -1), "notify_kind")
    lookup = reg.kind("CACHE_LOOKUP", table="cache", payload=payload)
    fill = reg.kind("CACHE_FILL", table="cache", payload=payload)

    def row(world, name, e, r):
        return tu.take(getattr(world, name), e.agent, r)

    def answer(env, e, delay):
        """Emit slot 0, the requester's notify event: whether it asked for
        one, and the slot's fields."""
        nlp = tu.f2i(e.payload[:, 2])
        return nlp >= 0, dict(
            time=e.time + env.delay(delay), kind=tu.f2i(e.payload[:, 3]),
            dst=torch.clamp_min(nlp, 0),
            payload=hd.pad_payload([e.payload[:, 1]], e.time.shape[0],
                                   e.time.device))

    @reg.on(lookup)
    def h_cache_lookup(env, world, counters, e):
        c = row(world, "lp_res", e, e.dst)
        keys = row(world, "cache_keys", e, c)
        hit = torch.any(keys == tu.f2i(e.payload[:, 0])[:, None], dim=1)
        counters = mon.bump(counters, c_lookups)
        out = hd.Emits(e)
        asked, note = answer(env, e, row(world, "cache_hit_lat", e, c))
        out.set(0, valid=hit & asked, **note)
        # miss: the backend fetch lands as a CACHE_FILL to self
        out.set(1, valid=~hit,
                time=e.time + env.delay(row(world, "cache_miss_lat", e, c)),
                kind=fill.id, dst=e.dst, payload=e.payload)
        delta = env.delta(
            world, "cache", c, cache_keys=keys,
            cache_ptr=row(world, "cache_ptr", e, c),
            cache_hits=row(world, "cache_hits", e, c) + hit.to(i32),
            cache_miss=row(world, "cache_miss", e, c) + (~hit).to(i32))
        return delta, counters, out.batch()

    @reg.on(fill)
    def h_cache_fill(env, world, counters, e):
        c = row(world, "lp_res", e, e.dst)
        keys = row(world, "cache_keys", e, c)
        ptr = row(world, "cache_ptr", e, c)
        key = tu.f2i(e.payload[:, 0])
        already = torch.any(keys == key[:, None], dim=1)  # a racing fill
        slot = ptr % keys.shape[1]                        # FIFO: the oldest
        lanes = torch.arange(keys.shape[0], device=keys.device)
        old = keys[lanes, slot.clamp(0, keys.shape[1] - 1)]
        keys = hd.set_slot(keys, slot, torch.where(already, old, key))
        counters = mon.bump(counters, c_fills, (~already).to(i32))
        out = hd.Emits(e)
        asked, note = answer(env, e, 1)
        out.set(0, valid=asked, **note)
        delta = env.delta(
            world, "cache", c, cache_keys=keys,
            cache_ptr=ptr + (~already).to(i32),
            cache_hits=row(world, "cache_hits", e, c),
            cache_miss=row(world, "cache_miss", e, c))
        return delta, counters, out.batch()

    return dict(cache=cache, CACHE_LOOKUP=lookup, CACHE_FILL=fill)


# The extended registry: the builtins and the cache model. A scenario built
# with ``CacheScenarioBuilder`` has a World type that carries it, so the
# engine, the oracle and the sync pick its dispatch table up.
CACHE_REGISTRY = BUILTIN.extend()
_DEFS = register_cache_model(CACHE_REGISTRY)
CACHE = _DEFS["cache"]
CACHE_LOOKUP = _DEFS["CACHE_LOOKUP"]
CACHE_FILL = _DEFS["CACHE_FILL"]
K_CACHE_LOOKUP = CACHE_LOOKUP.id
K_CACHE_FILL = CACHE_FILL.id
LPK_CACHE = CACHE.lp_kind
C_CACHE_LOOKUPS = CACHE_REGISTRY.counter_index("CACHE_LOOKUPS")
C_CACHE_FILLS = CACHE_REGISTRY.counter_index("CACHE_FILLS")


class CacheScenarioBuilder(ScenarioBuilder):
    """The builtin builder plus the generated ``add_cache(...)``."""

    _registry = CACHE_REGISTRY

    def __init__(self, cache_ways: int = 8, max_cpu: int = 16,
                 queue_cap: int = 32, max_link: int = 8, max_flow: int = 64):
        ScenarioBuilderBase.__init__(
            self, cache_ways=cache_ways, max_cpu=max_cpu, queue_cap=queue_cap,
            max_link=max_link, max_flow=max_flow)


def build_churn_scenario(*, n_caches: int = 8, n_keys: int = 4,
                         n_rounds: int = 6, cache_ways: int = 8,
                         hit_lat: int = 1, miss_lat: int = 6,
                         lookahead: int = 4, n_agents: int = 1,
                         pool_cap: int = 1024, **build_kw):
    """A lookup-churn scenario: every round sends one lookup per cache (keys
    cycle mod ``n_keys``), so the first rounds miss and later ones hit once
    the working set fits in ``cache_ways``. Lookups land on distinct cache
    rows per window; the fills land between rounds."""
    b = CacheScenarioBuilder(cache_ways=cache_ways, max_cpu=1, queue_cap=2,
                             max_link=1, max_flow=2)
    sink = b.add_idle_lp()
    caches = [b.add_cache(cache_hit_lat=hit_lat, cache_miss_lat=miss_lat)
              for _ in range(n_caches)]
    period = 2 * lookahead + miss_lat
    for r in range(n_rounds):
        for c in caches:
            b.add_event(time=1 + r * period, kind=CACHE_LOOKUP,
                        src=sink, dst=c,
                        payload=CACHE_LOOKUP.pack(key=r % n_keys, size=1.0,
                                                  notify_lp=sink,
                                                  notify_kind=0))
    built = b.build(n_agents=n_agents, lookahead=lookahead,
                    t_end=period * (n_rounds + 2), pool_cap=pool_cap,
                    **build_kw)
    return built, caches
