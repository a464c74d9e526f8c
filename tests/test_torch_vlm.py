"""The port's vlm family (qwen2-vl) against the JAX package, in float32 on
the CPU: multimodal RoPE with distinct (t, h, w) positions, and the smoke
model with 16 patch slots through ``prefill_fn`` and one ``decode_fn``
step, logits and the whole state at atol = rtol = 1e-4."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from zoo_harness import TOL, assert_state_close, models  # noqa: E402


def positions3(b: int, s: int, side: int) -> np.ndarray:
    """Qwen2-VL's positions: the first side * side slots a patch grid (t 0,
    h the row, w the column), the text after it going on from ``side`` in
    all three."""
    n = side * side
    i = np.arange(s)
    text = side + i - n
    pos = np.stack([np.where(i < n, 0, text),
                    np.where(i < n, i // side, text),
                    np.where(i < n, i % side, text)])
    return np.ascontiguousarray(
        np.broadcast_to(pos[:, None], (3, b, s))).astype(np.int32)


def test_m_rope_matches_jax():
    rng = np.random.default_rng(3)
    for b, s, h, hd, theta in ((2, 24, 3, 16, 1e6), (1, 40, 2, 128, 1e4)):
        x = rng.standard_normal((b, s, h, hd)).astype(np.float32)
        pos = positions3(b, s, 4)
        pos[:, -1] = rng.integers(0, 1000, (3, s))   # three streams apart
        want = np.asarray(JL.apply_m_rope(jnp.asarray(x), jnp.asarray(pos),
                                          theta))
        got = L.apply_m_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        # the three streams differ: the same x under plain RoPE does not
        # give the same angles
        plain = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]),
                             theta)
        assert not torch.allclose(plain, got, atol=1e-3)


def test_vlm_model_matches_jax():
    jm, params, tm = models("qwen2-vl-72b", cache_headroom=4)
    cfg = jm.cfg
    assert cfg.m_rope and cfg.use_bias
    b, s, n_patch = 2, 24, 16
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
    patches = rng.standard_normal((b, n_patch, cfg.d_model)).astype(
        np.float32)
    batch = {"tokens": toks, "patch_embeds": patches,
             "positions3": positions3(b, s, 4)}
    jlogits, jstate = jax.jit(jm.prefill_fn)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tlogits, tstate = tm.prefill_fn(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    assert_state_close(jstate, tstate)
    # without the patches the logits differ: they were written in
    no_patch, _ = tm.prefill_fn({"tokens": torch.from_numpy(toks),
                                 "positions3": torch.from_numpy(
                                     batch["positions3"])})
    assert not torch.allclose(no_patch, tlogits, atol=1e-3)
    jlogits, jstate = jax.jit(jm.decode_fn)(params, jstate, jnp.asarray(nxt),
                                            jnp.int32(s))
    tlogits, tstate = tm.decode_fn(tstate, torch.from_numpy(nxt), s)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)
    assert_state_close(jstate, tstate)
    with pytest.raises(ValueError, match="patch"):
        tm.prefill_fn({"tokens": torch.from_numpy(toks[:, :8]),
                       "patch_embeds": torch.from_numpy(patches)})
