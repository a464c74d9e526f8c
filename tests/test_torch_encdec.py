"""The port's encdec family (whisper) against the JAX package, in float32
on the CPU: the smoke model over 64 frames and 8 decoder tokens through
``prefill_fn`` and one ``decode_fn`` step (logits, the decoder's KV caches
and the cross-attention K/V at atol = rtol = 1e-4), its encoder alone over
whisper's 1,500 frames (where the sinusoidal positions' angles reach 1,500
rad), and the LayerNorm and the ungated (tanh-GELU) MLP it is built of."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.configs.registry import smoke_config  # noqa: E402
from repro_torch.convert import model_params_from_numpy  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from zoo_harness import TOL, assert_state_close, flat_params, models  # noqa: E402


def test_encdec_model_matches_jax():
    jm, params, tm = models("whisper-large-v3")
    cfg = jm.cfg
    assert cfg.encoder_layers == 2 and cfg.use_bias
    b, n_frames, s = 2, 64, 8
    rng = np.random.default_rng(5)
    frames = rng.standard_normal((b, n_frames, cfg.d_model)).astype(
        np.float32)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
    # nonzero biases, so the cross K/V's lack of them is tested
    for name in list(params["layers"]["xattn"]):
        if name.startswith("b"):
            params["layers"]["xattn"][name] = jnp.asarray(
                rng.standard_normal(params["layers"]["xattn"][name].shape),
                jnp.float32)
    tm.load_state_dict(model_params_from_numpy(tm.cfg, flat_params(params)))
    jlogits, jstate = jax.jit(jm.prefill_fn)(
        params, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)})
    tlogits, tstate = tm.prefill_fn({"frames": torch.from_numpy(frames),
                                     "tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    assert sorted(tstate) == ["cross", "kv"]
    assert tstate["cross"][0].shape == (cfg.n_layers, b, n_frames, cfg.n_kv,
                                        cfg.head_dim)
    assert tstate["kv"].k.shape[2] == cfg.decoder_len
    assert_state_close(jstate, tstate)
    jlogits, jstate = jax.jit(jm.decode_fn)(params, jstate, jnp.asarray(nxt),
                                            jnp.int32(s))
    tlogits, tstate = tm.decode_fn(tstate, torch.from_numpy(nxt), s)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    assert_state_close(jstate, tstate)
    # the encoder alone at whisper's 1,500 frames
    frames = rng.standard_normal((b, 1500, cfg.d_model)).astype(np.float32)
    want = jax.jit(jm._encode)(params, {"frames": jnp.asarray(frames)})
    with torch.no_grad():
        got = tm._encode({"frames": torch.from_numpy(frames)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_layernorm_and_ungated_mlp_match_jax():
    cfg = dataclasses.replace(smoke_config("whisper-large-v3"),
                              dtype="float32")
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 5, cfg.d_model)) * 3 + 1).astype(np.float32)
    gamma, beta = (rng.standard_normal(cfg.d_model).astype(np.float32)
                   for _ in range(2))
    want = JL.layernorm(jnp.asarray(x), jnp.asarray(gamma),
                        jnp.asarray(beta), cfg.norm_eps)
    got = L.layernorm(*map(torch.from_numpy, (x, gamma, beta)), cfg.norm_eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    p = {"wi": rng.standard_normal((cfg.d_model, cfg.d_ff)) * 0.2,
         "wo": rng.standard_normal((cfg.d_ff, cfg.d_model)) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    want = np.asarray(JL.mlp({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x)))
    got = L.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # tanh-approximated: the exact GELU is further off than the tolerance
    exact = (torch.nn.functional.gelu(torch.from_numpy(x @ p["wi"]))
             @ torch.from_numpy(p["wo"])).numpy()
    assert np.abs(exact - want).max() > 1e-4
