"""The port's moe family against the JAX package, in float32 on the CPU.

``moe_ffn`` at a prefill shape whose capacity drops tokens and at one
token (decode): the slot tables built from the reference's own top-k
choices equal its tables exactly, and the port's ``y`` and ``aux`` are
within atol = rtol = 1e-4. Then moonshot's smoke model (a leading dense
layer, so ``kv_first``) and mixtral's (window 32, S = 48 past it) through
``prefill_fn``, one ``decode_fn`` step and the whole state, and greedy
tokens from moonshot's ``ServeEngine`` against the JAX engine's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs.registry import smoke_config  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from zoo_harness import TOL, assert_state_close, models  # noqa: E402


def reference_moe(p, x, cfg, monkeypatch):
    """The reference's (y, aux) and, caught from its ``shard`` calls, its
    top-k choices (flat_expert, flat_gate) and slot tables (tok_of_slot,
    gate_of_slot)."""
    seen = []

    def grab(t, names):
        seen.append(t)
        return t

    monkeypatch.setattr(jmoe, "shard", grab)

    def fn(p, x):
        y, aux = jmoe.moe_ffn(p, x, cfg)
        return y, aux, seen[0], seen[1], seen[3], seen[4]

    return [np.array(a) for a in jax.jit(fn)(p, x)]


def test_moe_ffn_matches_reference(monkeypatch):
    base = dataclasses.replace(smoke_config("moonshot-v1-16b-a3b"),
                               dtype="float32")
    jbase = dataclasses.replace(jax_smoke_config("moonshot-v1-16b-a3b"),
                                dtype="float32")
    rng = np.random.default_rng(11)
    # (b, s, capacity factor): a prefill whose capacity of 8 slots (0.4 *
    # 40 * 2 / 4) for 20 choices an expert on average drops tokens, and
    # decode (s = 1: cap = min(8, k) = 2, nothing dropped)
    for b, s, cf in ((2, 40, 0.4), (3, 1, 1.25)):
        cfg = dataclasses.replace(base, capacity_factor=cf)
        jcfg = dataclasses.replace(jbase, capacity_factor=cf)
        params = {k: v.value for k, v in
                  jmoe.init_moe(jax.random.PRNGKey(s), jcfg).items()}
        x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        y, aux, flat_expert, flat_gate, tok, gate = reference_moe(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
            jcfg, monkeypatch)
        p = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
        r = M.slot_tables(torch.from_numpy(flat_expert),
                          torch.from_numpy(flat_gate), cfg)
        assert r.cap == M.capacity(cfg, s) == tok.shape[1] // cfg.n_experts
        assert np.array_equal(r.tok_of_slot.numpy(), tok)
        assert np.array_equal(r.gate_of_slot.numpy().view(np.int32),
                              gate.view(np.int32))
        dropped = b * s * cfg.top_k - int((gate > 0).sum())
        assert int((~r.kept).sum()) == dropped
        assert (dropped > 0) == (s > 1), dropped
        # the port's own routing from the same x: the same choices
        mine, my_aux = M.route(p, torch.from_numpy(x), cfg)
        assert np.array_equal(mine.tok_of_slot.numpy(), tok)
        np.testing.assert_allclose(mine.gate_of_slot.numpy(), gate, **TOL)
        got, got_aux = M.moe_ffn(p, torch.from_numpy(x), cfg)
        assert got.dtype == torch.float32 and got.shape == (b, s, cfg.d_model)
        np.testing.assert_allclose(got.numpy(), y, **TOL)
        np.testing.assert_allclose(float(got_aux), float(aux), **TOL)


def test_moe_models_match_jax():
    rng = np.random.default_rng(7)
    for arch, b, s, over in (
            ("moonshot-v1-16b-a3b", 2, 24, dict(cache_headroom=4)),
            ("mixtral-8x22b", 2, 48, {})):
        jm, params, tm = models(arch, **over)
        assert (tm.cfg.moe_first_dense == 1) == (arch != "mixtral-8x22b")
        toks = rng.integers(0, jm.cfg.vocab, (b, s)).astype(np.int32)
        nxt = rng.integers(0, jm.cfg.vocab, (b, 1)).astype(np.int32)
        jlogits, jstate = jax.jit(jm.prefill_fn)(
            params, {"tokens": jnp.asarray(toks)})
        tlogits, tstate = tm.prefill_fn({"tokens": torch.from_numpy(toks)})
        assert tlogits.shape == (b, jm.cfg.vocab)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   err_msg=arch, **TOL)
        assert_state_close(jstate, tstate)
        jlogits, jstate = jax.jit(jm.decode_fn)(
            params, jstate, jnp.asarray(nxt), jnp.int32(s))
        tlogits, tstate = tm.decode_fn(tstate, torch.from_numpy(nxt), s)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   err_msg=arch, **TOL)
        assert_state_close(jstate, tstate)

    # moonshot's engine: four prompts left-padded to 20, six greedy tokens
    jm, params, tm = models("moonshot-v1-16b-a3b", seed=3, cache_headroom=6)
    prompts = [rng.integers(1, jm.cfg.vocab, n).tolist()
               for n in (20, 13, 5, 17)]
    jreqs = [JRequest(rid=i, tokens=p, max_new=6)
             for i, p in enumerate(prompts)]
    treqs = [Request(rid=i, tokens=p, max_new=6)
             for i, p in enumerate(prompts)]
    JServeEngine(jm, params, batch_slots=4, prompt_len=20).run(jreqs,
                                                               max_ticks=8)
    ServeEngine(tm, batch_slots=4, prompt_len=20, device="cpu").run(
        treqs, max_ticks=8)
    for j, t in zip(jreqs, treqs):
        assert t.done and len(t.out) == 6
        assert t.out == j.out, (t.rid, t.out, j.out)
