"""Declarative component & handler registry (counterpart of
``repro.core.registry``).

A model author declares components (structure-of-arrays tables), event kinds
with named payloads, and one handler per kind; the registry generates the
``World``/``WorldOwnership``/``WorldDelta`` structs, the kind -> table map the
conflict mask keys on, the delta scatter and the owner-wins sync.

Differences from the reference, all forced by the explicit agent dimension:

* a state ``World`` carries a leading agent dimension ``A`` (the builder's
  unstacked world has none);
* handlers run over a lane dimension ``B``: ``fn(env, world, counters, e)``
  gets the stacked world, (B, n_counters) zero increment vectors and an
  :class:`Ev` whose fields are (B,) tensors plus the lane's agent index, and
  returns ``(delta, counters, emits)`` with a (B, MAX_EMIT) emit batch;
* a delta is a dict holding the row column and the mutable fields of the
  components it writes, one value per lane (an empty dict writes nothing;
  ``NO_ROW`` leaves a lane's row untouched).
"""
from __future__ import annotations

import collections
import dataclasses
import importlib
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import monitoring as _mon
from repro_torch.core import tensor_util as tu

PAYLOAD = 8

# Sentinel row index meaning "this delta writes no row of that table".
NO_ROW = 2**31 - 1

LPS_CREATED = 0
LPS_READY = 1
LPS_RUNNING = 2
LPS_WAITING = 3
LPS_FINISHED = 4

LP_FIELDS = ("lp_kind", "lp_agent", "lp_res", "lp_state", "lp_lvt", "lp_ctx")

_NP_DTYPE = {torch.float32: np.float32, torch.int32: np.int32,
             torch.bool: np.bool_}


class RegistryError(ValueError):
    """A scenario/model declaration violated the registry's rules."""


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """One column of a component table (``shape`` is per row; strings name
    builder dims). ``mutable`` fields are the ones handlers may write."""

    shape: tuple
    dtype: Any
    mutable: bool = False
    fill: Any = 0
    doc: str = ""


class PayloadSpec:
    """Named, typed view of an event kind's payload scalars.

    Fields are ``"name"`` (float32, default 0.0), ``("name", default)`` or
    ``("name", default, dtype)``. An ``int32`` field is stored as its raw
    bits in the float32 payload lane (numpy views on the host,
    ``Tensor.view(torch.int32)`` on tensors), so any 32-bit int survives.
    """

    def __init__(self, *fields):
        self.names: tuple[str, ...] = ()
        self.defaults: dict[str, Any] = {}
        self.dtypes: dict[str, Any] = {}
        for f in fields:
            if isinstance(f, str):
                name, default, dtype = f, 0.0, torch.float32
            elif len(f) == 2:
                (name, default), dtype = f, torch.float32
            else:
                name, default, dtype = f
            if not isinstance(name, str) or not name.isidentifier():
                raise RegistryError(f"payload field name {name!r} must be an "
                                    "identifier")
            if name in self.defaults:
                raise RegistryError(f"duplicate payload field {name!r}")
            if dtype not in (torch.float32, torch.int32):
                raise RegistryError(
                    f"payload field {name!r} dtype must be float32 or int32, "
                    f"got {dtype}")
            self.names += (name,)
            self.dtypes[name] = dtype
            self.defaults[name] = (int(default) if dtype == torch.int32
                                   else float(default))
        if len(self.names) > PAYLOAD:
            raise RegistryError(
                f"payload has {len(self.names)} fields; the engine carries at "
                f"most PAYLOAD={PAYLOAD} scalars per event")

    def index(self, name: str) -> int:
        try:
            return self.names.index(name)
        except ValueError:
            raise RegistryError(f"unknown payload field {name!r}; "
                                f"declared: {self.names}") from None

    def _check_known(self, values):
        unknown = set(values) - set(self.names)
        if unknown:
            raise RegistryError(f"unknown payload field(s) {sorted(unknown)}; "
                                f"declared: {self.names}")

    def pack(self, **values) -> np.ndarray:
        """Positional float32 payload row from named values (host side)."""
        self._check_known(values)
        row = np.zeros((len(self.names),), np.float32)
        for i, n in enumerate(self.names):
            v = values.get(n, self.defaults[n])
            if self.dtypes[n] == torch.int32:
                row[i] = np.asarray(int(v), np.int32).view(np.float32)
            else:
                row[i] = v
        return row

    def pack_tensor(self, **values) -> torch.Tensor:
        """A (B, PAYLOAD) float32 payload batch from named (B,) tensors or
        scalars (the tensor counterpart of :meth:`pack`; the reference's
        ``pack_jax``). Int32 fields are stored as their raw bits
        (``Tensor.view``), never converted numerically; the batch is only
        copied into, so every bit pattern survives."""
        self._check_known(values)
        tensors = [v for v in values.values() if isinstance(v, torch.Tensor)]
        if not tensors:
            raise RegistryError("pack_tensor needs at least one (B,) tensor")
        lanes = torch.broadcast_shapes(*(v.shape for v in tensors))
        row = torch.zeros(lanes + (PAYLOAD,), dtype=torch.float32,
                          device=tensors[0].device)
        for i, n in enumerate(self.names):
            v = values.get(n, self.defaults[n])
            if self.dtypes[n] == torch.int32:
                v = torch.as_tensor(v, device=row.device).to(
                    torch.int32).view(torch.float32)
            row[..., i] = v
        return row

    def get(self, payload: torch.Tensor, name: str) -> torch.Tensor:
        """One named scalar of a (..., PAYLOAD) payload; int32 fields are
        bit-exact views."""
        v = payload[..., self.index(name)]
        if self.dtypes[name] == torch.int32:
            return v.contiguous().view(torch.int32)
        return v

    def __repr__(self):
        return f"PayloadSpec({', '.join(self.names)})"


@dataclasses.dataclass(frozen=True)
class ComponentDef:
    name: str
    table_id: int
    fields: dict
    doc: str = ""

    @property
    def lp_kind(self) -> int:
        return self.table_id

    @property
    def row_field(self) -> str:
        return f"{self.name}_row"

    @property
    def own_field(self) -> str:
        return f"{self.name}_lp"

    @property
    def first_field(self) -> str:
        return next(iter(self.fields))

    def mutable_fields(self):
        return tuple(f for f, s in self.fields.items() if s.mutable)


@dataclasses.dataclass(frozen=True)
class EventKindDef:
    name: str
    id: int
    table: str | None
    payload: PayloadSpec

    def pack(self, **values):
        return self.payload.pack(**values)


class Ev(NamedTuple):
    """A lane batch of events handed to the handlers: (B,) fields, a
    (B, PAYLOAD) payload, and the agent whose world copy each lane reads."""

    time: torch.Tensor
    seq: torch.Tensor
    kind: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor
    ctx: torch.Tensor
    payload: torch.Tensor
    agent: torch.Tensor


class HandlerEnv:
    """Constants and helpers passed to every registered handler."""

    __slots__ = ("registry", "lookahead", "work_per_mb")

    def __init__(self, registry: "Registry", lookahead: int,
                 work_per_mb: float):
        self.registry = registry
        self.lookahead = lookahead
        self.work_per_mb = work_per_mb

    def delay(self, d):
        """Clamp an emit delay to the lookahead (the conservative-sync
        invariant: every emitted event lands >= lookahead ticks out)."""
        if isinstance(d, torch.Tensor):
            return torch.clamp_min(d.to(torch.int32), self.lookahead)
        return max(int(d), self.lookahead)

    def empty_delta(self, world):
        return {}

    def delta(self, world, component: str, row, **writes):
        return self.registry.make_delta(world, component, row, **writes)


class Registry:
    """Holds component/kind/handler declarations and generates engine tables."""

    def __init__(self):
        self._dims: dict[str, int] = {}
        self._components: dict[str, ComponentDef] = {}
        self._kinds: list[EventKindDef] = []
        self._handlers: dict[int, Callable] = {}
        self._counters: dict[str, int] = {
            name: i for i, (name, _doc) in enumerate(_mon.BUILTIN_COUNTERS)}
        self._counter_docs: dict[str, str] = dict(_mon.BUILTIN_COUNTERS)
        self._sealed = False
        self.deferred_handler_modules: list[str] = []
        self._cache: dict[str, Any] = {}

    # ------------------------------------------------------------ declaration
    def _check_open(self, what: str):
        if self._sealed:
            raise RegistryError(
                f"registry is sealed (a World/Delta struct was already "
                f"generated); cannot add {what}. Use .extend() to grow a "
                f"sealed registry.")

    def dim(self, name: str, default: int) -> str:
        self._check_open(f"dim {name!r}")
        if name in self._dims and self._dims[name] != default:
            raise RegistryError(f"dim {name!r} already declared with default "
                                f"{self._dims[name]}")
        self._dims[name] = int(default)
        return name

    @property
    def dims(self) -> dict:
        return dict(self._dims)

    def component(self, name: str, fields: dict, doc: str = "") -> ComponentDef:
        self._check_open(f"component {name!r}")
        if name in self._components:
            raise RegistryError(f"duplicate component {name!r}")
        if not fields:
            raise RegistryError(f"component {name!r} declares no fields")
        taken = set(LP_FIELDS)
        for comp in self._components.values():
            taken |= set(comp.fields) | {comp.row_field, comp.own_field}
        for fname, fs in fields.items():
            if not isinstance(fs, FieldSpec):
                raise RegistryError(f"{name}.{fname} must be a FieldSpec")
            if fname in taken:
                raise RegistryError(
                    f"field {fname!r} of component {name!r} collides with an "
                    "existing World column")
            for d in fs.shape:
                if isinstance(d, str) and d not in self._dims:
                    raise RegistryError(
                        f"{name}.{fname} shape names unknown dim {d!r}")
            if fs.mutable and fs.fill != 0 and fs.dtype == torch.float32:
                raise RegistryError(
                    f"{name}.{fname}: mutable float fields must use fill=0")
            taken.add(fname)
        comp = ComponentDef(name=name, table_id=len(self._components) + 1,
                            fields=dict(fields), doc=doc)
        self._components[name] = comp
        return comp

    @property
    def components(self) -> dict:
        return dict(self._components)

    def kind(self, name: str, table: str | None = None,
             payload: PayloadSpec | None = None) -> EventKindDef:
        self._check_open(f"kind {name!r}")
        if any(k.name == name for k in self._kinds):
            raise RegistryError(f"duplicate event kind {name!r}")
        kd = EventKindDef(name=name, id=len(self._kinds), table=table,
                          payload=payload or PayloadSpec())
        self._kinds.append(kd)
        return kd

    @property
    def kinds(self) -> tuple:
        return tuple(self._kinds)

    def kind_def(self, ref) -> EventKindDef:
        if isinstance(ref, EventKindDef):
            return ref
        if isinstance(ref, int):
            if not 0 <= ref < len(self._kinds):
                raise RegistryError(f"unknown kind id {ref}")
            return self._kinds[ref]
        for k in self._kinds:
            if k.name == ref:
                return k
        raise RegistryError(f"unknown event kind {ref!r}")

    def counter(self, name: str, doc: str = "") -> int:
        """Declare a named monitoring counter; returns its index (the
        builtin counters come first, each declaration appends). Handlers
        bump it with ``mon.bump``; the engine and the oracle size their
        counter vectors with :attr:`n_counters`."""
        self._check_open(f"counter {name!r}")
        if not name.isidentifier():
            raise RegistryError(f"counter name {name!r} must be an identifier")
        if name in self._counters:
            raise RegistryError(f"duplicate counter {name!r} "
                                f"(index {self._counters[name]})")
        idx = len(self._counters)
        self._counters[name] = idx
        self._counter_docs[name] = doc
        return idx

    @property
    def counters(self) -> dict:
        return dict(self._counters)

    @property
    def counter_docs(self) -> dict:
        return dict(self._counter_docs)

    @property
    def n_counters(self) -> int:
        return len(self._counters)

    def counter_index(self, name: str) -> int:
        try:
            return self._counters[name]
        except KeyError:
            raise RegistryError(
                f"unknown counter {name!r}; declared: "
                f"{sorted(self._counters)}") from None

    def on(self, kind) -> Callable:
        """Decorator registering ``fn(env, world, counters, e)`` for ``kind``."""
        kd = self.kind_def(kind)

        def register(fn):
            if kd.id in self._handlers:
                raise RegistryError(f"kind {kd.name!r} already has a handler")
            self._handlers[kd.id] = fn
            return fn

        return register

    def extend(self) -> "Registry":
        """An unsealed copy inheriting dims, components, kinds, handlers and
        counters: the extension point for models defined outside core. This
        registry stays as it was."""
        self._import_deferred()   # so its deferred handlers are copied
        child = Registry()
        child._dims = dict(self._dims)
        child._components = dict(self._components)
        child._kinds = list(self._kinds)
        child._handlers = dict(self._handlers)
        child._counters = dict(self._counters)
        child._counter_docs = dict(self._counter_docs)
        return child

    # ----------------------------------------------------------------- freeze
    def _seal(self):
        if self._sealed:
            return
        for k in self._kinds:
            if k.table is not None and k.table not in self._components:
                raise RegistryError(
                    f"kind {k.name!r} declares table {k.table!r}, which is "
                    "not a registered component")
        self._sealed = True

    def _import_deferred(self):
        for mod in self.deferred_handler_modules:
            importlib.import_module(mod)

    # ------------------------------------------------------- generated tables
    @property
    def n_kinds(self) -> int:
        return len(self._kinds)

    @property
    def n_tables(self) -> int:
        return len(self._components) + 1

    @property
    def kind_table(self) -> tuple:
        self._seal()
        return tuple(
            0 if k.table is None else self._components[k.table].table_id
            for k in self._kinds)

    def _struct(self, key: str, name: str, field_names: tuple, doc: str,
                extra: dict | None = None):
        if key not in self._cache:
            base = collections.namedtuple(name, field_names)
            ns = {"__slots__": (), "__doc__": doc, "_registry": self}
            ns.update(extra or {})
            self._cache[key] = type(name, (base,), ns)
        return self._cache[key]

    def world_struct(self):
        self._seal()
        names = LP_FIELDS + tuple(
            f for comp in self._components.values() for f in comp.fields)
        return self._struct(
            "world", "World", names,
            "All mutable simulation state (generated from the registry).",
            {"n_lp": property(lambda s: s.lp_kind.shape[-1])})

    def ownership_struct(self):
        self._seal()
        names = tuple(c.own_field for c in self._components.values())
        return self._struct("own", "WorldOwnership", names,
                            "res -> LP inverse maps (generated).")

    def delta_struct(self):
        self._seal()
        names = tuple(
            n for comp in self._components.values()
            for n in (comp.row_field,) + comp.mutable_fields())
        return self._struct("delta", "WorldDelta", names,
                            "Typed per-row write set (generated).")

    @property
    def delta_schema(self) -> dict:
        self._seal()
        return {f: comp.row_field for comp in self._components.values()
                for f in comp.mutable_fields()}

    @property
    def row_fields(self) -> tuple:
        self._seal()
        return tuple(c.row_field for c in self._components.values())

    @property
    def mutable_fields(self) -> tuple:
        return tuple(self.delta_schema)

    def sync_plan(self) -> dict:
        """World field -> sync rule: ``"lp"`` (per-LP owner-wins), a
        component name (owner-wins with that table's mask) or
        ``"replicated"`` (a build-time input, never synced)."""
        self._seal()
        plan = {f: "replicated" for f in LP_FIELDS}
        plan["lp_state"] = plan["lp_lvt"] = "lp"
        for comp in self._components.values():
            for fname, fs in comp.fields.items():
                plan[fname] = comp.name if fs.mutable else "replicated"
        return plan

    def resolve_shape(self, shape: tuple, dims: dict) -> tuple:
        return tuple(dims[d] if isinstance(d, str) else d for d in shape)

    def max_rows(self, world) -> int:
        """Widest component table of an unstacked world."""
        return max((getattr(world, c.first_field).shape[0]
                    for c in self._components.values()), default=1)

    # --------------------------------------------------------------- numerics
    def make_delta(self, world, component: str, row, **writes) -> dict:
        """A validated delta declaring ``row`` of ``component`` and writing
        *every* mutable field of it (the whole-row-write contract)."""
        comp = self._components.get(component)
        if comp is None:
            raise RegistryError(f"unknown component {component!r}")
        mutable = set(comp.mutable_fields())
        bad = set(writes) - mutable
        if bad:
            raise RegistryError(
                f"delta writes non-mutable or unknown field(s) {sorted(bad)} "
                f"of component {component!r}")
        missing = mutable - set(writes)
        if missing:
            raise RegistryError(
                f"delta for component {component!r} must write every mutable "
                f"field of the row; missing: {sorted(missing)}")
        out = {comp.row_field: row.to(torch.int32)}
        for f, v in writes.items():
            x = getattr(world, f)
            if not isinstance(v, torch.Tensor):
                v = torch.tensor(v, dtype=x.dtype, device=row.device)
            out[f] = v.to(x.dtype).expand((row.shape[0],) + x.shape[2:])
        return out

    def apply_delta(self, world, delta: dict, agent: torch.Tensor):
        """Scatter a lane batch of deltas into a stacked world: lane ``i``
        writes row ``delta[<comp>_row][i]`` of agent ``agent[i]``'s copy.
        ``NO_ROW`` (and any out-of-range row) is dropped. Exact under the
        disjoint-write guarantee (no row is written by two lanes)."""
        out = {}
        for comp in self._components.values():
            rf = comp.row_field
            if rf in delta:
                fields = comp.mutable_fields()
                out.update(zip(fields, tu.scatter_many(
                    [getattr(world, f) for f in fields], agent, delta[rf],
                    [delta[f] for f in fields])))
        return world._replace(**out)

    def sync_world(self, world, own):
        """Owner-wins replication sync over the agent dimension.

        Mutable fields sum ``where(mine, row, 0)`` over agents (one nonzero
        contribution per row, so the order of the sum does not matter); int
        fields with a nonzero fill are shifted so the pad value survives; bool
        fields sum as int32, then ``> 0``. A single agent is the identity.
        """
        A = world.lp_kind.shape[0]
        if A == 1:
            return world
        me = torch.arange(A, dtype=torch.int32, device=world.lp_kind.device)

        def owner_wins(x, mask):
            m = mask.reshape(mask.shape + (1,) * (x.ndim - 2))
            if x.dtype == torch.bool:
                y = torch.where(m, x.to(torch.int32), 0).sum(
                    0, dtype=torch.int32) > 0
            elif x.dtype == torch.int32:
                y = torch.where(m, x, 0).sum(0, dtype=torch.int32)
            else:
                y = torch.where(m, x, torch.zeros((), dtype=x.dtype,
                                                  device=x.device)).sum(0)
            return y[None].expand_as(x).contiguous()

        lp_mine = world.lp_agent == me[:, None]
        out = {"lp_state": owner_wins(world.lp_state, lp_mine),
               "lp_lvt": owner_wins(world.lp_lvt, lp_mine)}
        for comp in self._components.values():
            res_lp = getattr(own, comp.own_field)
            mask = world.lp_agent[:, res_lp.long()] == me[:, None]
            for fname, fs in comp.fields.items():
                if not fs.mutable:
                    continue
                x = getattr(world, fname)
                if fs.fill != 0 and x.dtype != torch.bool:
                    out[fname] = owner_wins(x - fs.fill, mask) + fs.fill
                else:
                    out[fname] = owner_wins(x, mask)
        return world._replace(**out)

    def make_handlers(self, lookahead: int, work_per_mb: float = 1.0) -> list:
        """One ``(world, counters, e)`` lane kernel per kind id, in kind order."""
        self._seal()
        self._import_deferred()
        missing = [k.name for k in self._kinds if k.id not in self._handlers]
        if missing:
            raise RegistryError(f"no handler registered for kind(s) "
                                f"{missing}; attach one with @registry.on")
        env = HandlerEnv(self, lookahead, work_per_mb)

        def bind(fn):
            def kernel(world, counters, e, _fn=fn):
                return _fn(env, world, counters, e)
            kernel.__name__ = fn.__name__
            return kernel

        return [bind(self._handlers[k.id]) for k in self._kinds]


def registry_of(obj) -> Registry:
    reg = getattr(type(obj), "_registry", None)
    if reg is None:
        raise RegistryError(
            f"{type(obj).__name__} was not generated by a Registry")
    return reg


# ---------------------------------------------------------------------------
# Scenario spec + builder base (host side)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """Static facts about a built scenario (same fields as the reference)."""

    n_agents: int
    n_ctx: int
    lookahead: int
    t_end: int
    pool_cap: int
    emit_cap: int
    route_cap: int
    n_lp: int
    work_per_mb: float = 1.0
    exec_policy: Any = 256      # a static width or a policy.ExecPolicy
    batched_dispatch: bool = True
    merge_mode: str = "delta"
    insert_mode: str = "ring"
    fused_select: bool = False

    @property
    def exec_cap(self) -> int:
        """The static per-window execution width of ``run_local``: the int
        itself, or an adaptive policy's initial-rung width."""
        p = self.exec_policy
        return p if isinstance(p, int) else p.ladder[p.init_rung]


class ScenarioBuilderBase:
    """Generic registry-driven scenario builder (host side, numpy inside).

    ``build()`` returns CPU tensors: the unstacked ``World``, the ownership
    maps, the initial event batch and the :class:`ScenarioSpec`. The engine
    moves them to its device."""

    _registry: Registry

    def __init__(self, **dims):
        reg = self._registry
        unknown = set(dims) - set(reg.dims)
        if unknown:
            raise RegistryError(f"unknown builder dim(s) {sorted(unknown)}")
        self.dims = {**reg.dims, **{k: int(v) for k, v in dims.items()}}
        for k, v in self.dims.items():
            setattr(self, k, v)
        self._lps: list[dict] = []
        self._rows: dict[str, list] = {c: [] for c in reg.components}
        self._events: list[dict] = []
        self._seq = 0

    def __getattr__(self, name):
        # add_<component> for components without a bespoke wrapper
        if name.startswith("add_"):
            comp = type(self)._registry.components.get(name[len("add_"):])
            if comp is not None:
                return lambda **kw: self.add_component(comp.name, **kw)
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}")

    def _new_lp(self, kind: int, res: int, ctx: int) -> int:
        self._lps.append(dict(kind=kind, res=res, ctx=ctx))
        return len(self._lps) - 1

    def add_component(self, name: str, *, ctx: int = 0, **fields) -> int:
        reg = self._registry
        comp = reg.components.get(name)
        if comp is None:
            raise RegistryError(f"unknown component {name!r}")
        unknown = set(fields) - set(comp.fields)
        if unknown:
            raise RegistryError(
                f"unknown field(s) {sorted(unknown)} for component {name!r}")
        for fname, value in fields.items():
            shape = reg.resolve_shape(comp.fields[fname].shape, self.dims)
            v = np.asarray(value)
            if v.ndim != len(shape):
                raise RegistryError(
                    f"{name}.{fname} expects a rank-{len(shape)} row, got "
                    f"shape {v.shape}")
            if len(shape) >= 1 and v.shape[0] > shape[0]:
                raise RegistryError(
                    f"{name}.{fname} row of length {v.shape[0]} exceeds the "
                    f"declared dim {shape[0]}")
            if len(shape) >= 2 and v.shape[1:] != shape[1:]:
                raise RegistryError(
                    f"{name}.{fname} trailing shape {v.shape[1:]} must match "
                    f"declared {shape[1:]}")
        self._rows[name].append(dict(fields))
        return self._new_lp(comp.lp_kind, len(self._rows[name]) - 1, ctx)

    def add_idle_lp(self, ctx: int = 0) -> int:
        """A bare LP with no component row (lp_kind 0): a NOOP event sink."""
        return self._new_lp(0, 0, ctx)

    def add_event(self, *, time: int, kind, src: int, dst: int, payload=(),
                  ctx: int = 0):
        self._events.append(dict(time=time, seq=self._seq,
                                 kind=getattr(kind, "id", kind), src=src,
                                 dst=dst, payload=payload, ctx=ctx))
        self._seq += 1

    def build(self, *, n_agents: int = 1, n_ctx: int = 1, lookahead: int,
              t_end: int, pool_cap: int = 1024, emit_cap: int | None = None,
              route_cap: int | None = None, exec_cap: int | None = None,
              exec_policy=None, placement=None, work_per_mb: float = 1.0,
              batched_dispatch: bool = True, merge_mode: str = "delta",
              insert_mode: str = "ring", fused_select: bool = False):
        from repro_torch.core import events as ev   # late: events imports us

        reg = self._registry
        World = reg.world_struct()
        nlp = max(len(self._lps), 1)
        i32 = np.int32

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a))

        lp_kind = np.asarray([l["kind"] for l in self._lps] or [0], i32)
        lp_res = np.asarray([l["res"] for l in self._lps] or [0], i32)
        lp_ctx = np.asarray([l["ctx"] for l in self._lps] or [0], i32)
        lp_agent = (np.arange(nlp, dtype=i32) % n_agents if placement is None
                    else np.asarray(placement, i32))
        vals = dict(lp_kind=lp_kind, lp_agent=lp_agent, lp_res=lp_res,
                    lp_state=np.full((nlp,), LPS_READY, i32),
                    lp_lvt=np.zeros((nlp,), i32), lp_ctx=lp_ctx)
        n_rows = {}
        for comp in reg.components.values():
            rows = self._rows[comp.name]
            n = max(len(rows), 1)
            n_rows[comp.name] = n
            for fname, spec in comp.fields.items():
                shape = (n,) + reg.resolve_shape(spec.shape, self.dims)
                dt = _NP_DTYPE[spec.dtype]
                arr = np.full(shape, spec.fill, dt)
                for i, row in enumerate(rows):
                    if fname not in row:
                        continue
                    v = np.asarray(row[fname], dt)
                    if v.ndim == 0:
                        arr[i] = v
                    else:
                        arr[i, : v.shape[0]] = v
                vals[fname] = arr
        world = World(**{k: t(v) for k, v in vals.items()})

        def inverse_map(comp):
            out = [0] * n_rows[comp.name]
            for lp, l in enumerate(self._lps):
                if l["kind"] == comp.lp_kind:
                    out[l["res"]] = lp
            return t(np.asarray(out, i32))

        own = reg.ownership_struct()(**{
            comp.own_field: inverse_map(comp)
            for comp in reg.components.values()})

        if exec_policy is not None and exec_cap is not None:
            raise RegistryError(
                "pass either exec_cap (static width) or exec_policy "
                "(adaptive ladder), not both")
        if exec_policy is None:
            exec_policy = max(exec_cap if exec_cap is not None
                              else min(pool_cap, 256), 1)
        spec = ScenarioSpec(
            n_agents=n_agents, n_ctx=n_ctx, lookahead=lookahead, t_end=t_end,
            pool_cap=pool_cap, emit_cap=emit_cap or pool_cap,
            route_cap=route_cap or max(pool_cap // max(n_agents, 1), 16),
            exec_policy=exec_policy, n_lp=nlp, work_per_mb=work_per_mb,
            batched_dispatch=batched_dispatch, merge_mode=merge_mode,
            insert_mode=insert_mode, fused_select=fused_select)
        init_events = ev.batch_from_rows(self._events)
        return world, own, init_events, spec
