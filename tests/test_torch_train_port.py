"""The port's training side on its own, on the CPU (no JAX program is
compiled here): the straggler monitor and the elastic plans on the
reference's own cases and against its plain-Python functions, a training
run stopped at a checkpoint and resumed equal to an unbroken one, the loss
falling on the structured stream, the autograd wrappers of the zoo's
kernels, the schedule and the norm, the inverse parameter conversion, and
the launcher's device rule."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.ft import elastic as jelastic  # noqa: E402  (plain Python)
from repro.ft.straggler import StragglerMonitor as JStragglerMonitor  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.configs.registry import smoke_config  # noqa: E402
from repro_torch.convert import (leaf_groups, model_params_from_numpy,  # noqa: E402
                                 model_params_to_numpy)
from repro_torch.data import pipeline as dp  # noqa: E402
from repro_torch.ft import elastic  # noqa: E402
from repro_torch.ft.straggler import StragglerMonitor  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import linear_rnn as R  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train.loop import make_train_step, train  # noqa: E402


def _tiny(**over):
    return dataclasses.replace(smoke_config("smollm-135m"), dtype="float32",
                               **over)


def test_straggler_monitor_as_the_reference():
    m, j = StragglerMonitor(n_hosts=4), JStragglerMonitor(n_hosts=4)
    for step in range(5):
        for h in range(4):
            for mon in (m, j):
                mon.record(h, step, 1.0 if h != 2 else 3.0)
    assert m.stragglers() == j.stragglers() == [2]
    plan = m.replacement_plan(np.zeros(6, np.int32), np.zeros(6, np.int32))
    assert plan.dtype == torch.int32 and 2 not in set(plan.tolist())
    assert m.eviction_recommendation() == j.eviction_recommendation() == {
        "evict_hosts": [2], "healthy": [0, 1, 3]}
    rng = np.random.default_rng(0)
    m, j = StragglerMonitor(6, alpha=0.3), JStragglerMonitor(6, alpha=0.3)
    for step in range(20):
        for h in rng.permutation(5):          # host 5 never reports
            t = float(rng.gamma(2.0, 1.0 + 2.0 * (h == 4)))
            m.record(int(h), step, t)
            j.record(int(h), step, t)
    np.testing.assert_array_equal(m.ewma, j.ewma)
    assert m.stragglers() == j.stragglers()
    assert StragglerMonitor(3).stragglers() == []


def test_elastic_plans_as_the_reference():
    p = elastic.plan_remesh(512, multi_pod=True)
    assert p.shape == (2, 16, 16) and p.axes == ("pod", "data", "model")
    p = elastic.plan_remesh(300)
    assert p.n_devices <= 300 and p.shape[-1] == 16
    assert elastic.plan_remesh(8).n_devices <= 8
    plan = elastic.reshard_plan(elastic.MeshPlan(("data", "model"), (16, 16)),
                                elastic.plan_remesh(128))
    assert plan["model"] == "keep" and "gather" in plan["data"]
    plans = []
    for n in range(1, 600):
        for mp in (1, 4, 16):
            for multi in (False, True):
                got = elastic.plan_remesh(n, model_parallel=mp,
                                          multi_pod=multi)
                want = jelastic.plan_remesh(n, model_parallel=mp,
                                            multi_pod=multi)
                assert (got.axes, got.shape) == (want.axes, want.shape)
                assert elastic.validate_plan(got, n)
                if n in (1, 7, 64, 300, 512):
                    plans.append((got, want))
    for a, ja in plans:
        for b, jb in plans:
            assert elastic.reshard_plan(a, b) == jelastic.reshard_plan(ja, jb)


def test_train_resumed_equals_unbroken(tmp_path, monkeypatch):
    """6 steps unbroken; a 6-step run stopped after step 4 (its data stream
    ends there) with a checkpoint after step 3, then a new run on that
    directory: it restores step 3, runs steps 4 and 5, and ends with the
    unbroken run's parameters and moments, bit for bit."""
    from repro_torch.train import loop
    cfg = _tiny(n_layers=1)
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=2)
    dcfg = dp.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4)
    p_u, o_u, h_u = train(build_model(cfg, "cpu"), tc, steps=6,
                          data_cfg=dcfg)
    d = str(tmp_path / "ck")
    stream = dp.batch_iterator

    def stopped(*a, **kw):
        for step, batch in stream(*a, **kw):
            if step > 4:
                return
            yield step, batch

    monkeypatch.setattr(loop.dp, "batch_iterator", stopped)
    _, _, h_a = train(build_model(cfg, "cpu"), tc, steps=6, data_cfg=dcfg,
                      ckpt_dir=d, ckpt_every=3)
    monkeypatch.setattr(loop.dp, "batch_iterator", stream)
    p_r, o_r, h_b = train(build_model(cfg, "cpu"), tc, steps=6,
                          data_cfg=dcfg, ckpt_dir=d, ckpt_every=3)
    assert len(h_a) == 5 and h_b == h_u[4:]
    h_a = h_a[:4]
    assert h_a + h_b == h_u
    assert int(o_r.step) == int(o_u.step) == 6
    for a, b in ((p_u, p_r), (o_u.m, o_r.m), (o_u.v, o_r.v)):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_loss_decreases_on_structured_data():
    """The reference's test: 2 layers, vocab 64, 30 steps of the Markov
    stream at lr 3e-3; the mean loss of the last 5 steps is 0.2 below the
    first 5's."""
    cfg = _tiny(n_layers=2, vocab=64)
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    opt = topt.init_opt_state(params)
    step = make_train_step(model, TrainConfig(learning_rate=3e-3,
                                              warmup_steps=5))
    dcfg = dp.DataConfig(vocab=64, seq_len=64, global_batch=8)
    losses = []
    for i in range(30):
        params, opt, m = step(params, opt, dp.batch_for_shard(dcfg, i, 0, 1))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


@pytest.mark.parametrize("causal,window,kv", [(True, 0, 2), (True, 5, 1),
                                              (False, 0, 4)])
def test_flash_attention_function(causal, window, kv):
    """Forward: the plain version (the kernel's on the card), within 1e-5
    of the reference's chunked form; backward: the chunked form's
    gradients, exactly."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 24, h, 16, generator=g, requires_grad=True)
               for h in (4, kv, kv))
    out = L.FlashAttention.apply(q, k, v, causal, window, 8, 16)
    plain = L.chunked_attention(q, k, v, causal=causal, window=window,
                                chunk_q=8, chunk_kv=16)
    torch.testing.assert_close(out, plain, atol=1e-5, rtol=1e-5)
    gout = torch.randn(out.shape, generator=g)
    got = torch.autograd.grad(out, (q, k, v), gout)
    want = torch.autograd.grad(plain, (q, k, v), gout)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["k", "v"])
def test_gla_scan_function(mode):
    """The same for the chunked scan, its final state's gradient too: the
    backward is the float64 chunked form's gradient exactly, within 1e-4
    of the float32 form's (the reference's), and the float32 form is
    within 1e-4 of the sequential one."""
    g = torch.Generator().manual_seed(2)
    q, k = (torch.randn(2, 32, 3, 8, generator=g) for _ in range(2))
    v = torch.randn(2, 32, 3, 16, generator=g)
    w = torch.rand(2, 32, 3, 8 if mode == "k" else 16, generator=g) * 0.5 \
        + 0.45
    u = torch.randn(3, 8, generator=g) if mode == "k" else None
    ins = [x.requires_grad_() for x in (q, k, v, w) + ((u,) if u is not None
                                                       else ())]
    bonus = ins[4] if u is not None else None
    out, st = R.GlaScan.apply(*ins[:4], bonus, mode, 8)
    pout, pst = R.gla_chunked_plain(*ins[:4], bonus, mode=mode, chunk=8)
    torch.testing.assert_close(out, pout, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(st, pst, atol=1e-4, rtol=1e-4)
    go, gs = torch.randn(out.shape, generator=g), torch.randn(st.shape,
                                                             generator=g)
    got = torch.autograd.grad((out, st), ins, (go, gs))
    o64, s64 = R.gla_chunked_plain(*ins[:4], bonus, mode=mode, chunk=8,
                                   dtype=torch.float64)
    want = torch.autograd.grad((o64, s64), ins, (go.double(), gs.double()))
    f32 = torch.autograd.grad((pout, pst), ins, (go, gs))
    for a, b, c in zip(got, want, f32):
        assert a.dtype == torch.float32 and torch.equal(a, b)
        torch.testing.assert_close(a, c, atol=1e-4, rtol=1e-4)
    seq, _ = R.gla_ref(*[x.detach() for x in ins[:4]],
                       bonus=None if u is None else u, mode=mode)
    torch.testing.assert_close(pout, seq, atol=1e-4, rtol=1e-4)


def test_gla_scan_gradient_past_the_float32_range():
    """Decays of 0.45 over a chunk of 64 (cumulative 6e-23): the float32
    chunked form, as the reference's, is finite forward, but its gradient
    of the decays is not (v / Qs**2 overflows); the port's backward, in
    float64, is finite and equals the sequential form's (which divides by
    nothing), within atol 1e-4, rtol 1e-3."""
    g = torch.Generator().manual_seed(3)
    q, k = (torch.randn(1, 64, 2, 16, generator=g) for _ in range(2))
    v = torch.randn(1, 64, 2, 32, generator=g)
    w = torch.full((1, 64, 2, 32), 0.45)
    ins = [x.clone().requires_grad_() for x in (q, k, v, w)]
    pout, _ = R.gla_chunked_plain(*ins, mode="v", chunk=64)
    assert torch.isfinite(pout).all()
    f32 = torch.autograd.grad(pout.sum(), ins)
    assert not torch.isfinite(f32[3]).all()
    out, _ = R.GlaScan.apply(*ins, None, "v", 64)
    got = torch.autograd.grad(out.sum(), ins)
    ins64 = [x.detach().double().requires_grad_() for x in ins]
    seq, _ = R.gla_ref(*ins64, mode="v")
    want = torch.autograd.grad(seq.sum(), ins64)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b.float(), atol=1e-4, rtol=1e-3)


def test_schedule_norm_and_leaf_order():
    tc = TrainConfig(learning_rate=1.0, warmup_steps=10)
    lr = [float(topt.lr_schedule(torch.tensor(s, dtype=torch.int32), tc,
                                 110)) for s in (0, 5, 10, 60, 110, 200)]
    want = [0.0, 0.5, 1.0, 0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi / 2)),
            0.1, 0.1]
    np.testing.assert_allclose(lr, want, rtol=1e-6, atol=1e-7)
    names = ["layers.10.mlp.wi", "embed.tok", "layers.2.mlp.wi",
             "final_norm", "layers.2.attn.wq", "first_layers.0.ln1"]
    assert leaf_groups(names) == {
        "embed/tok": ["embed.tok"], "final_norm": ["final_norm"],
        "first_layers/ln1": ["first_layers.0.ln1"],
        "layers/attn/wq": ["layers.2.attn.wq"],
        "layers/mlp/wi": ["layers.2.mlp.wi", "layers.10.mlp.wi"]}
    tree = {n: torch.full((3,), float(i)) for i, n in enumerate(names)}
    np.testing.assert_allclose(float(topt.global_norm(tree)),
                               math.sqrt(3 * sum(i * i for i in range(6))),
                               rtol=1e-6)


def test_params_to_numpy_inverts_from_numpy():
    for arch in ("moonshot-v1-16b-a3b", "whisper-large-v3"):
        cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
        model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(3))
        flat = model_params_to_numpy(model.state_dict())
        assert flat["layers/attn/wq"].shape[0] == cfg.n_layers \
            - cfg.moe_first_dense
        back = model_params_from_numpy(cfg, flat)
        for k, t in model.state_dict().items():
            assert torch.equal(back[k], t), k


def test_launcher_device_rule_and_serving_records_no_graph():
    """Without a card the launcher raises (no CPU fallback); with ``--device
    cpu`` it trains; a model whose gradients are on serves without a
    graph."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            launch_train.main(["--steps", "1"])
    out = launch_train.main(["--arch", "whisper-large-v3", "--steps", "2",
                             "--seq-len", "16", "--global-batch", "2",
                             "--device", "cpu"])
    assert len(out["history"]) == 2 and all(map(math.isfinite,
                                                out["history"]))
    model = build_model(_tiny(), "cpu").init(torch.Generator().manual_seed(0))
    make_train_step(model, TrainConfig())
    assert all(p.requires_grad for p in model.parameters())
    logits, state = model.prefill_fn({"tokens": torch.zeros((1, 8),
                                                            dtype=torch.long)})
    assert logits.grad_fn is None and state["kv"].k.grad_fn is None
