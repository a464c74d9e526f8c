"""The port's sharding rules and leaf names against the JAX package's, on
the CPU with no JAX compile: ``spec_for`` on the reference's own cases and
on a seeded grid (shapes x logical names x the single, two-pod and
one-chip meshes x every rule variant); ``Model.param_names`` and the leaf
shapes against ``split_annotated(init)`` under ``jax.eval_shape`` for the
ten archs' smoke configs; and the dry run's input and decode-state names.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices when it is
imported; ``_reference_dryrun`` imports it with the variable restored
afterwards, so this process keeps its one device."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.registry import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import sharding as jsh  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.configs.registry import ARCHS, smoke_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import sharding as sh  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

MESHES = (make_production_mesh(False), make_production_mesh(True),
          {"data": 1, "model": 1})


def _reference_dryrun():
    before = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jdr
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return jdr


def test_spec_for_on_the_reference_cases_and_a_seeded_grid():
    mesh, mesh3 = MESHES[0], MESHES[1]
    # the four cases of tests/test_dryrun_smoke.py
    assert sh.spec_for((1536,), ("mlp",), sh.DEFAULT_RULES, mesh) == \
        ("model",)
    assert sh.spec_for((9, 64), ("heads", "head"), sh.DEFAULT_RULES,
                       mesh) == (None, None)
    assert sh.spec_for((256, 4096), ("batch", "seq"), sh.DEFAULT_RULES,
                       mesh3) == (("pod", "data"), None)
    assert sh.spec_for((32, 32), ("heads", "mlp"), sh.DEFAULT_RULES,
                       mesh) == ("model", None)
    jdr = _reference_dryrun()
    assert sh.DEFAULT_RULES == jsh.DEFAULT_RULES
    assert dryrun.RULE_VARIANTS == jdr.RULE_VARIANTS
    names = sorted(sh.DEFAULT_RULES)
    dims = (1, 2, 8, 9, 16, 25, 32, 48, 256, 4096)
    rng = np.random.default_rng(27)
    n = 0
    for rules_name, rules in dryrun.RULE_VARIANTS.items():
        for ms in MESHES:
            for _ in range(40):
                k = int(rng.integers(1, 5))
                shape = tuple(int(d) for d in rng.choice(dims, k))
                nm = tuple(str(x) for x in rng.choice(names, k))
                want = jsh.spec_for(shape, nm, jdr.RULE_VARIANTS[rules_name],
                                    ms)
                got = sh.spec_for(shape, nm, rules, ms)
                assert got == tuple(want), (rules_name, ms, shape, nm)
                n += 1
    assert n == 6 * 3 * 40


def _flat_names(tree) -> dict:
    is_names = lambda x: isinstance(x, tuple) and all(  # noqa: E731
        isinstance(s, str) for s in x)
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_names)[0]
    return {".".join(str(k.key) for k in path): leaf for path, leaf in leaves}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_names_and_shapes_are_the_references(arch):
    jm = jax_build_model(jax_smoke_config(arch))
    holder = {}

    def init(r):
        vals, names = jm.init(r)
        holder["names"] = names
        return vals

    sds = jax.eval_shape(init, jax.random.PRNGKey(0))
    want_names = _flat_names(holder["names"])
    want_shapes = {k: (tuple(v.shape), str(v.dtype)) for k, v in
                   _flat_names(jax.tree.map(lambda x: x, sds)).items()}
    tm = build_model(smoke_config(arch), device="meta")
    assert tm.param_names() == want_names
    got = {k: (shape, str(dt).replace("torch.", ""))
           for k, (shape, dt, _) in tm.leaves().items()}
    assert got == want_shapes
    # every leaf's placement on the production mesh, as the reference's
    specs = sh.param_specs(tm, sh.DEFAULT_RULES, MESHES[1])
    for k, (shape, _, names) in tm.leaves().items():
        assert specs[k] == tuple(jsh.spec_for(shape, names, jsh.DEFAULT_RULES,
                                              MESHES[1]))


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict / tuple / KVCache of leaves."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (tuple, list)) and tree and not isinstance(
            tree[0], str):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}."))
        return out
    return {prefix: tree}


def test_input_and_decode_state_names_are_the_references():
    jdr = _reference_dryrun()
    for arch in ARCHS:
        cfg = smoke_config(arch)
        jm = jax_build_model(jax_smoke_config(arch))
        tm = build_model(cfg, device="meta")
        for name in ("train_4k", "prefill_32k", "decode_32k"):
            shape = dataclasses.replace(SHAPES[name], seq_len=2048,
                                        global_batch=4)
            jshape = dataclasses.replace(JSHAPES[name], seq_len=2048,
                                         global_batch=4)
            jin = jm.input_specs(jshape)
            tin = tm.input_specs(shape)
            assert list(tin) == list(jin), (arch, name)
            assert {k: tuple(v.shape) for k, v in tin.items()} == \
                {k: tuple(v.shape) for k, v in jin.items()}
            assert dryrun._input_names(tin) == jdr._input_names(jin)
        jstate = jm.decode_state_specs(jshape)
        tstate = tm.decode_state_specs(shape)
        want = _flat(jdr.decode_state_names(jm, jstate))
        got = _flat(dryrun.decode_state_names(tm, tstate))
        assert got == want, arch
        shapes = {k: tuple(v.shape) for k, v in _flat(tstate).items()
                  if v is not None}
        assert shapes == {k: tuple(v.shape) for k, v in
                          _flat(jstate).items() if v is not None}, arch
