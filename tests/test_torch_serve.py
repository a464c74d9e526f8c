"""The port's ServeEngine and serve launcher, on the CPU.

Greedy tokens of the port's engine equal the JAX engine's on hymba-1.5b's
smoke config in float32 (the JAX params carried over as numpy); the
launcher runs with ``--device cpu``; and the engine, the model and the
launcher need a CUDA card unless told ``device="cpu"``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs.registry import smoke_config as jax_smoke_config  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs.registry import smoke_config  # noqa: E402
from repro_torch.convert import model_params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import Model, build_model  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from zoo_harness import flat_params  # noqa: E402


def test_greedy_tokens_match_jax_engine():
    """Four requests of different lengths, left-padded to 40 (past hymba's
    smoke window of 32), eight greedy tokens each, ring cache wrapping."""
    over = dict(dtype="float32", cache_headroom=8)
    jcfg = dataclasses.replace(jax_smoke_config("hymba-1.5b"), **over)
    cfg = dataclasses.replace(smoke_config("hymba-1.5b"), **over)
    jm = jax_build_model(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(3))
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(model_params_from_numpy(cfg, flat_params(params)))

    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in (40, 25, 7, 33)]
    jreqs = [JRequest(rid=i, tokens=p, max_new=8) for i, p in
             enumerate(prompts)]
    treqs = [Request(rid=i, tokens=p, max_new=8) for i, p in
             enumerate(prompts)]
    JServeEngine(jm, params, batch_slots=4, prompt_len=40).run(jreqs,
                                                               max_ticks=10)
    ServeEngine(tm, batch_slots=4, prompt_len=40, device="cpu").run(
        treqs, max_ticks=10)
    for j, t in zip(jreqs, treqs):
        assert t.done and len(t.out) == 8
        assert t.out == j.out, (t.rid, t.out, j.out)


def test_launcher_runs_on_the_cpu(capsys):
    got = serve.main(["--arch", "rwkv6-7b", "--requests", "3",
                      "--batch-slots", "2", "--max-new", "5",
                      "--prompt-len", "16", "--device", "cpu"])
    assert got["done"] == got["requests"] == 3
    assert got["tokens"] == 15
    assert "[serve] 3/3 requests, 15 tokens" in capsys.readouterr().out


def test_serving_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_config("hymba-1.5b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(build_model(cfg, device="cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "hymba-1.5b"])
    ServeEngine(build_model(cfg, device="cpu"), device="cpu")
