"""Declarative scenario catalog: named, parameterized experiments
(counterpart of ``repro.scenarios.catalog``).

A user asks for "the T0/T1 replication study at 2 MB/s", not for a
hand-assembled ``ScenarioSpec``. A :class:`ScenarioDef` is a frozen
declaration — a name, a docstring, the declared parameters with their
defaults, and a build callable returning the ``(world, own, init_events,
spec)`` tuple every driver consumes — and the module-level registry
(:func:`register` / :func:`get` / :func:`names`) is the lookup the
``simulate run <name> [--set k=v]`` CLI resolves against, dispatching
through :class:`repro_torch.fleet.Orchestrator`. Each built-in entry calls
this package's builders and builds what the reference's entry builds.

Authoring a new entry:

    from repro_torch.scenarios import catalog

    def _build_mine(*, knob=4, n_agents=1):
        b = ScenarioBuilder(...)
        ...
        return b.build(n_agents=n_agents, lookahead=2, t_end=1000)

    catalog.register(catalog.ScenarioDef(
        name="mine", doc="what it models", build=_build_mine,
        params=(("knob", 4), ("n_agents", 1))))

``params`` declares exactly the overridable surface: an override naming an
undeclared parameter is a loud :class:`CatalogError`, and override values
are coerced to the declared default's type (so ``--set wan_bw=0.5`` works
from the CLI's strings).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping


class CatalogError(ValueError):
    """Unknown scenario name, duplicate registration, or a bad override."""


def _coerce(value, default):
    """Coerce a (possibly string) override to the declared default's type."""
    if isinstance(value, str) and not isinstance(default, str):
        if isinstance(default, bool):
            if value.lower() in ("1", "true", "yes"):
                return True
            if value.lower() in ("0", "false", "no"):
                return False
            raise CatalogError(f"cannot parse {value!r} as a bool")
        try:
            return type(default)(value)
        except ValueError as e:
            raise CatalogError(
                f"cannot parse {value!r} as {type(default).__name__}") from e
    return value


@dataclasses.dataclass(frozen=True)
class ScenarioDef:
    """One catalog entry: a named, parameterized scenario declaration.

    ``build(**params)`` must return the ``(world, own, init_events, spec)``
    tuple of ``ScenarioBuilderBase.build``. ``params`` is the declared
    override surface as ``(name, default)`` pairs — :meth:`resolve` rejects
    overrides outside it. ``driver`` is the orchestrator dispatch hint
    (``"auto"`` picks distributed/adaptive from the device count and the
    spec's exec policy; ``"ensemble"`` marks a vmap-over-seeds entry whose
    ``replicas``/``seed0`` params size the seed vector instead of being
    build arguments).
    """

    name: str
    doc: str
    build: Callable[..., tuple]
    params: tuple[tuple[str, Any], ...] = ()
    driver: str = "auto"

    def defaults(self) -> dict[str, Any]:
        return dict(self.params)

    def resolve(self, overrides: Mapping[str, Any] | None = None):
        """Apply overrides and build. Returns ``(built, params)`` where
        ``built`` is the 4-tuple the engine/orchestrator consumes and
        ``params`` the fully-resolved parameter dict (the run's record)."""
        params = self.defaults()
        for key, value in (overrides or {}).items():
            if key not in params:
                raise CatalogError(
                    f"scenario {self.name!r} has no parameter {key!r}; "
                    f"declared: {', '.join(sorted(params)) or '(none)'}")
            params[key] = _coerce(value, params[key])
        build_kw = {k: v for k, v in params.items()
                    if k not in ("replicas", "seed0")}
        return self.build(**build_kw), params


_CATALOG: dict[str, ScenarioDef] = {}


def register(scenario: ScenarioDef) -> ScenarioDef:
    """Add an entry to the catalog (duplicate names are rejected)."""
    if scenario.name in _CATALOG:
        raise CatalogError(f"scenario {scenario.name!r} already registered")
    if scenario.driver == "ensemble" and "replicas" not in dict(scenario.params):
        raise CatalogError(
            f"ensemble scenario {scenario.name!r} must declare a "
            f"'replicas' parameter")
    _CATALOG[scenario.name] = scenario
    return scenario


def get(name: str) -> ScenarioDef:
    """Look up an entry by name (loud on unknown names)."""
    try:
        return _CATALOG[name]
    except KeyError:
        raise CatalogError(
            f"unknown scenario {name!r}; catalog has: "
            f"{', '.join(names())}") from None


def names() -> tuple[str, ...]:
    """All registered scenario names, sorted."""
    return tuple(sorted(_CATALOG))


def resolve(name: str, overrides: Mapping[str, Any] | None = None):
    """``get(name).resolve(overrides)`` in one call."""
    return get(name).resolve(overrides)


# --------------------------------------------------------- builtin entries
def _build_t0t1(*, wan_bw=2.0, n_flows=16, interval=20, flow_mb=40.0,
                lookahead=2, n_agents=1, pool_cap=512, t_end=20_000,
                exec_cap=0, fused=False):
    """The paper's T0/T1 replication study: production at tier-0 generates
    WAN transfers; each arrival triggers an analysis job at tier-1 whose
    output lands in tier-1 storage (the quickstart/Fig-2 scenario)."""
    from repro_torch.core import ScenarioBuilder
    from repro_torch.core.components import DATA_WRITE, FLOW_START, JOB_SUBMIT

    b = ScenarioBuilder(max_cpu=4, queue_cap=16, max_link=4, max_flow=32)
    b.add_regional_center(n_cpu=2, cpu_power=10.0, disk=1000.0,
                          tape=10000.0, tape_rate=5.0)
    t1 = b.add_regional_center(n_cpu=2, cpu_power=8.0, disk=500.0,
                               tape=5000.0, tape_rate=5.0)
    wan = b.add_net_region(link_bws=[wan_bw, wan_bw], link_lats=[5, 5])
    b.add_generator(
        target_lp=wan, kind=FLOW_START,
        payload=FLOW_START.pack(size=flow_mb, l0=0, notify_lp=t1["farm"],
                                notify_kind=JOB_SUBMIT.id,
                                notify2_lp=t1["storage"],
                                notify2_kind=DATA_WRITE.id),
        interval=interval, count=n_flows, start=0)
    extra = dict(exec_cap=exec_cap) if exec_cap else {}
    return b.build(n_agents=n_agents, lookahead=lookahead, t_end=t_end,
                   pool_cap=pool_cap, work_per_mb=2.0, fused_select=fused,
                   **extra)


def _build_cache_churn(*, n_caches=8, n_keys=4, n_rounds=6, cache_ways=8,
                       n_agents=1, pool_cap=1024, fused=False):
    from repro_torch.scenarios.cache import build_churn_scenario

    built, _caches = build_churn_scenario(
        n_caches=n_caches, n_keys=n_keys, n_rounds=n_rounds,
        cache_ways=cache_ways, n_agents=n_agents, pool_cap=pool_cap,
        fused_select=fused)
    return built


def _build_failure_farm(*, n_farms=8, n_cpu=4, burst=3, n_bursts=6,
                        jobs_per_farm=4, seed=1, n_agents=1, pool_cap=1024,
                        fused=False):
    from repro_torch.scenarios.failures import build_failure_scenario

    built, _info = build_failure_scenario(
        n_farms=n_farms, n_cpu=n_cpu, burst=burst, n_bursts=n_bursts,
        jobs_per_farm=jobs_per_farm, seed=seed, n_agents=n_agents,
        pool_cap=pool_cap, fused_select=fused)
    return built


def _build_ensemble_farm(*, n_farms=2, n_cpu=4, burst=3, n_bursts=6,
                         pool_cap=128):
    from repro_torch.scenarios.failures import build_failure_scenario

    built, _info = build_failure_scenario(
        n_farms=n_farms, n_cpu=n_cpu, burst=burst, n_bursts=n_bursts,
        pool_cap=pool_cap)
    return built


register(ScenarioDef(
    name="t0t1",
    doc="T0/T1 replication study: WAN transfers trigger tier-1 analysis "
        "jobs and storage writes (the paper's Fig-2 scenario at one "
        "bandwidth point)",
    build=_build_t0t1,
    params=(("wan_bw", 2.0), ("n_flows", 16), ("interval", 20),
            ("flow_mb", 40.0), ("lookahead", 2), ("n_agents", 1),
            ("pool_cap", 512), ("t_end", 20_000), ("exec_cap", 0),
            ("fused", False))))

register(ScenarioDef(
    name="cache_churn",
    doc="replica-cache lookup churn: per-round lookups miss cold and hit "
        "warm (the outside-core registry-extension component)",
    build=_build_cache_churn,
    params=(("n_caches", 8), ("n_keys", 4), ("n_rounds", 6),
            ("cache_ways", 8), ("n_agents", 1), ("pool_cap", 1024),
            ("fused", False))))

register(ScenarioDef(
    name="failure_farm",
    doc="compute farms under failure/repair churn contending with a job "
        "workload (failure-process extension LPs)",
    build=_build_failure_farm,
    params=(("n_farms", 8), ("n_cpu", 4), ("burst", 3), ("n_bursts", 6),
            ("jobs_per_farm", 4), ("seed", 1), ("n_agents", 1),
            ("pool_cap", 1024), ("fused", False))))

register(ScenarioDef(
    name="ensemble_farm",
    doc="Monte-Carlo failure-farm ensemble: R seed-perturbed replicas in "
        "one fused vmap-over-seeds launch",
    build=_build_ensemble_farm,
    params=(("replicas", 8), ("seed0", 1), ("n_farms", 2), ("n_cpu", 4),
            ("burst", 3), ("n_bursts", 6), ("pool_cap", 128)),
    driver="ensemble"))
