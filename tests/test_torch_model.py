"""The port's serving model against the JAX model, in float32 on the CPU.

One test per served family at smoke size: dense (smollm-135m, GQA group
2, tied embeddings), hybrid (hymba-1.5b: sliding-window attention and SSD
heads, S = 48 past the window of 32, so the ring cache is full at the
decode step) and ssm (rwkv6-7b). The JAX params cross over as numpy
through ``convert.model_params_from_numpy``; the same tokens go through
both models' ``prefill_fn`` and one ``decode_fn`` step, and the logits and
the whole decode state are compared at atol = rtol = 1e-4 (the same float32
math in other summation orders: the port runs the chunked recurrences and
attention through the plain versions of its kernels on the CPU, JAX through
``gla_chunked`` and ``_chunked_attention``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import smoke_config as jax_smoke_config  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch.configs.registry import smoke_config  # noqa: E402
from repro_torch.convert import model_params_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)


def flat_params(params) -> dict:
    """A JAX params tree as {tree path joined with '/': numpy array}."""
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in leaves}


def models(arch: str, **over):
    """(JAX model, JAX params, port model) of one smoke config in float32,
    the port holding the JAX params."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32",
                               **over)
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32", **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jm = jax_build_model(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(model_params_from_numpy(cfg, flat_params(params)))
    return jm, params, tm


def assert_state_close(jstate, tstate):
    jkv, tkv = jstate["kv"], tstate["kv"]
    assert (jkv is None) == (tkv is None)
    if jkv is not None:
        for name in ("k", "v", "length"):
            np.testing.assert_allclose(getattr(tkv, name).numpy(),
                                       np.asarray(getattr(jkv, name)),
                                       err_msg=f"kv.{name}", **TOL)
    jr, tr = jstate["rnn"], tstate["rnn"]
    assert (jr is None) == (tr is None)
    if jr is not None:
        assert sorted(jr) == sorted(tr)
        for name in jr:
            np.testing.assert_allclose(tr[name].numpy(), np.asarray(jr[name]),
                                       err_msg=f"rnn.{name}", **TOL)


@pytest.mark.parametrize("arch,b,s,over", [
    ("smollm-135m", 2, 24, dict(cache_headroom=4)),
    ("hymba-1.5b", 2, 48, {}),
    ("rwkv6-7b", 2, 40, {}),
])
def test_prefill_and_decode_match_jax(arch, b, s, over):
    jm, params, tm = models(arch, **over)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jm.cfg.vocab, (b, s)).astype(np.int32)
    nxt = rng.integers(0, jm.cfg.vocab, (b, 1)).astype(np.int32)

    jlogits, jstate = jax.jit(jm.prefill_fn)(params,
                                             {"tokens": jnp.asarray(toks)})
    tlogits, tstate = tm.prefill_fn({"tokens": torch.from_numpy(toks)})
    assert tlogits.dtype == torch.float32 and tlogits.shape == (b, jm.cfg.vocab)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    assert_state_close(jstate, tstate)

    jlogits, jstate = jax.jit(jm.decode_fn)(params, jstate, jnp.asarray(nxt),
                                            jnp.int32(s))
    tlogits, tstate = tm.decode_fn(tstate, torch.from_numpy(nxt), s)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    assert_state_close(jstate, tstate)
