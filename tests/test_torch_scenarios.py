"""The port's registry extension seam and its two extension models, against
the reference's declarations: counters (names, indices, docs), kinds and
table ids, the sync plan, the generated structs' fields, dtypes and shapes,
``extend()``, the builders' generated ``add_<component>`` and shape checks,
the bit-exact tensor payload pack, and the failure model's draws against
numpy models.

Nothing here compiles JAX code (the reference modules are imported for
their declarations only): comparisons that run JAX are in
tests/test_torch_cache.py and tests/test_torch_failures.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several worker processes on one machine: keep torch to one
# thread each, as the tensors here are small
torch.set_num_threads(1)

from repro.core import components as jcomp  # noqa: E402
from repro.scenarios import cache as jcache  # noqa: E402
from repro.scenarios import failures as jfail  # noqa: E402
from repro_torch.core import components as tcomp  # noqa: E402
from repro_torch.core import monitoring as tmon  # noqa: E402
from repro_torch.core.registry import (FieldSpec, PayloadSpec,  # noqa: E402
                                       Registry, RegistryError)
from repro_torch.scenarios import cache as tcache  # noqa: E402
from repro_torch.scenarios import failures as tfail  # noqa: E402

MODELS = {"cache": (tcache, jcache, "CACHE_REGISTRY"),
          "failures": (tfail, jfail, "FAIL_REGISTRY")}


def _dtype(d):
    return np.dtype(str(d).replace("torch.", ""))


@pytest.mark.parametrize("model", sorted(MODELS) + ["builtin"])
def test_registry_declarations_match_reference(model):
    if model == "builtin":
        t, j = tcomp.BUILTIN, jcomp.BUILTIN
    else:
        tm, jm, name = MODELS[model]
        t, j = getattr(tm, name), getattr(jm, name)
        public = {n for n in dir(jm) if n.isupper() or n.startswith(
            ("register_", "build_")) or n.endswith("Builder")}
        assert public - {"BUILTIN", "JOB_SUBMIT"} <= set(dir(tm))
        for n in public:
            if isinstance(getattr(jm, n), int):
                assert getattr(tm, n) == getattr(jm, n), n
    assert t.counters == j.counters
    assert t.counter_docs == j.counter_docs
    assert {n: t.counter_index(n) for n in t.counters} == j.counters
    assert t.n_counters == j.n_counters
    assert t.dims == j.dims
    assert [(k.name, k.id, k.table, k.payload.names)
            for k in t.kinds] == [(k.name, k.id, k.table, k.payload.names)
                                  for k in j.kinds]
    for tk, jk in zip(t.kinds, j.kinds):
        assert tk.payload.defaults == jk.payload.defaults
        assert [_dtype(tk.payload.dtypes[n]) for n in tk.payload.names] == \
            [np.dtype(jk.payload.dtypes[n]) for n in jk.payload.names]
    assert t.kind_table == j.kind_table and t.n_tables == j.n_tables
    assert t.sync_plan() == j.sync_plan()
    assert t.delta_schema == j.delta_schema
    for make in ("world_struct", "ownership_struct", "delta_struct"):
        assert getattr(t, make)()._fields == getattr(j, make)()._fields
    for (tn, tc), (jn, jc) in zip(t.components.items(), j.components.items()):
        # the extension models' docs are the reference's too
        doc = tn not in tcomp.BUILTIN.components
        assert (tn, tc.table_id) == (jn, jc.table_id)
        assert list(tc.fields) == list(jc.fields)
        assert not doc or tc.doc == jc.doc
        for f, ts in tc.fields.items():
            js = jc.fields[f]
            assert (ts.shape, ts.mutable, ts.fill) == \
                (js.shape, js.mutable, js.fill), f
            assert _dtype(ts.dtype) == np.dtype(js.dtype), f
            assert not doc or ts.doc == js.doc, f


def test_extend_copies_and_leaves_the_parent_untouched():
    before = (tcomp.BUILTIN.counters, tcomp.BUILTIN.counter_docs,
              tuple(tcomp.BUILTIN.components), tcomp.BUILTIN.kinds,
              tcomp.BUILTIN.dims)
    assert "cache" not in tcomp.BUILTIN.components
    assert "fproc" not in tcomp.BUILTIN.components
    assert "CPU_FAILS" not in tcomp.BUILTIN.counters
    child = tcomp.BUILTIN.extend()
    child.dim("extra", 3)
    child.component("extra", fields=dict(x=FieldSpec((), torch.int32)))
    child.counter("EXTRA", "an extra counter")
    k = child.kind("EXTRA_KIND", table="extra")
    assert k.id == tcomp.N_KINDS
    assert (tcomp.BUILTIN.counters, tcomp.BUILTIN.counter_docs,
            tuple(tcomp.BUILTIN.components), tcomp.BUILTIN.kinds,
            tcomp.BUILTIN.dims) == before
    # the builtin handlers came along; the new kind has none yet
    with pytest.raises(RegistryError, match="EXTRA_KIND"):
        child.make_handlers(2)

    parent = Registry()
    parent.dim("d", 2)
    parent.component("p", fields=dict(v=FieldSpec((), torch.int32,
                                                  mutable=True)))
    kid = parent.extend()
    assert not parent._sealed and not kid._sealed
    parent.counter("AFTER")          # the parent stays open, apart
    assert "AFTER" not in kid.counters
    kid.world_struct()
    assert not parent._sealed


def test_counter_declaration_and_validation():
    reg = tcomp.BUILTIN.extend()
    assert reg.counter_docs == dict(tmon.BUILTIN_COUNTERS)
    i = reg.counter("MY_STAT", "a statistic")
    assert i == tmon.N_COUNTERS and reg.n_counters == tmon.N_COUNTERS + 1
    assert reg.counter_index("MY_STAT") == i
    assert reg.counter_docs["MY_STAT"] == "a statistic"
    with pytest.raises(RegistryError, match="duplicate counter"):
        reg.counter("MY_STAT")
    with pytest.raises(RegistryError, match="identifier"):
        reg.counter("not an id")
    with pytest.raises(RegistryError, match="unknown counter"):
        reg.counter_index("NOPE")
    reg.world_struct()
    with pytest.raises(RegistryError, match="extend"):
        reg.counter("LATE")
    snap = tmon.snapshot(torch.arange(reg.n_counters, dtype=torch.int32),
                         reg)
    assert snap["MY_STAT"] == i


def test_builder_generated_add_and_shape_checks():
    b = tcache.CacheScenarioBuilder(cache_ways=4)
    sink = b.add_idle_lp()
    c = b.add_cache(cache_keys=[3, 4], cache_hit_lat=2)
    assert c == sink + 1
    with pytest.raises(AttributeError, match="add_nothing"):
        b.add_nothing
    with pytest.raises(RegistryError, match="unknown field"):
        b.add_component("cache", bogus=1)
    with pytest.raises(RegistryError, match="exceeds"):
        b.add_cache(cache_keys=[1, 2, 3, 4, 5])
    with pytest.raises(RegistryError, match="rank"):
        b.add_cache(cache_ptr=[1, 2])
    # a field of two dimensions must match its trailing shape
    with pytest.raises(RegistryError, match="trailing shape"):
        b.add_component("farm", jobq=np.zeros((2, 5)))
    b.add_component("farm", jobq=np.zeros((2, 6)))
    world = b.build(lookahead=2, t_end=10)[0]
    np.testing.assert_array_equal(world.cache_keys[0].numpy(), [3, 4, -1, -1])
    assert int(world.cache_hit_lat[0]) == 2
    f = tfail.FailureScenarioBuilder(max_cpu=2)
    lp = f.add_fproc(fp_target=0, fp_rng=-7)
    assert f.build(lookahead=1, t_end=5)[0].fp_rng.tolist() == [-7]
    assert lp == 0


def test_pack_tensor_is_bit_exact():
    p = PayloadSpec(("token", 0, torch.int32), "size", ("lp", -1),
                    ("n", 5, torch.int32))
    toks = np.array([(1 << 31) - 1, 0x7F800001, 0x7FC00001, 1, 3, -5,
                     -(1 << 31), 0], np.int32)
    size = np.linspace(-2, 2, toks.size).astype(np.float32)
    row = p.pack_tensor(token=torch.from_numpy(toks),
                        size=torch.from_numpy(size))
    assert row.shape == (toks.size, 8) and row.dtype == torch.float32
    want = np.stack([p.pack(token=int(t), size=float(s))
                     for t, s in zip(toks, size)])
    np.testing.assert_array_equal(row[:, :4].numpy().view(np.int32),
                                  want.view(np.int32))
    assert not row[:, 4:].any()
    np.testing.assert_array_equal(p.get(row, "token").numpy(), toks)
    assert p.get(row, "n").tolist() == [5] * toks.size
    assert p.get(row, "lp").tolist() == [-1.0] * toks.size
    one = p.pack_tensor(n=torch.tensor(-9, dtype=torch.int32))
    assert one.shape == (8,) and int(p.get(one, "n")) == -9
    with pytest.raises(RegistryError, match="tensor"):
        p.pack_tensor(token=3)
    with pytest.raises(RegistryError, match="unknown payload"):
        p.pack_tensor(bogus=torch.zeros(2))


def test_failure_draws_match_numpy_models():
    """The LCG against int64 arithmetic taken mod 2**32, the unit draw
    against numpy float32, the log replica within one ulp of float64's log
    (on every seventh unit value) and apart from ``torch.log`` (which
    differs from XLA's log on about one value in seven)."""
    rng = np.random.default_rng(3)
    x = rng.integers(-2**31, 2**31, 256).astype(np.int32)
    xt = torch.from_numpy(x)
    for _ in range(50):
        y = (x.astype(np.int64) * 1664525 + 1013904223) % 2**32
        x = np.where(y >= 2**31, y - 2**32, y).astype(np.int32)
        xt = tfail._lcg(xt)
        np.testing.assert_array_equal(xt.numpy(), x)
        u = (((x >> 9) & (2**22 - 1)).astype(np.float32) + np.float32(0.5)) \
            / np.float32(2**22)
        np.testing.assert_array_equal(tfail._unit(xt).numpy(), u)
    k = np.arange(0, 1 << 22, 7, dtype=np.int32)
    u = ((k.astype(np.float32) + np.float32(0.5)) / np.float32(1 << 22))
    got = tfail.xla_log(torch.from_numpy(u)).numpy()
    ref = np.log(u.astype(np.float64)).astype(np.float32)
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - ref.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    tl = torch.log(torch.from_numpy(u)).numpy()
    assert (tl.view(np.int32) != got.view(np.int32)).sum() > 0.05 * u.size
    d = tfail._expo(torch.from_numpy(x), torch.full((x.size,), 6,
                                                    dtype=torch.int32))
    assert int(d.min()) >= 1 and int(d.max()) <= 48
