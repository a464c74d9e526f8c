"""What the model-zoo tests share: a JAX params tree as numpy, a smoke
config's JAX model beside the port's holding the same params, and the
comparison of two decode states (every cache, cross K/V and recurrent
state) at the model tests' tolerance."""
import dataclasses

import jax
import numpy as np

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models.model import build_model as jax_build_model
from repro_torch.configs.registry import smoke_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.models.model import build_model

TOL = dict(atol=1e-4, rtol=1e-4)


def flat_params(params) -> dict:
    """A JAX params tree as {tree path joined with '/': numpy array}."""
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in leaves}


def models(arch: str, seed: int = 0, **over):
    """(JAX model, JAX params, port model) of one smoke config in float32,
    the port holding the JAX params."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32",
                               **over)
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32", **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jm = jax_build_model(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(model_params_from_numpy(cfg, flat_params(params)))
    return jm, params, tm


def assert_state_close(jstate: dict, tstate: dict) -> None:
    """The same keys, and every array of each within ``TOL``."""
    assert sorted(jstate) == sorted(tstate)
    for key in jstate:
        j, t = jstate[key], tstate[key]
        assert (j is None) == (t is None), key
        if j is None:
            continue
        if isinstance(j, dict):
            assert sorted(j) == sorted(t), key
            pairs = [(f"{key}.{n}", j[n], t[n]) for n in j]
        elif hasattr(j, "_fields"):
            pairs = [(f"{key}.{n}", getattr(j, n), getattr(t, n))
                     for n in j._fields]
        else:
            pairs = [(f"{key}[{i}]", a, b) for i, (a, b) in
                     enumerate(zip(j, t, strict=True))]
        for name, a, b in pairs:
            assert tuple(b.shape) == tuple(np.shape(a)), name
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       err_msg=name, **TOL)
