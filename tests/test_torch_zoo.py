"""The port's model-zoo pieces that need neither a card nor a compiled JAX
model: the config copies equal the reference's, the parameters of the
moe, vlm and encdec families have the reference's names, shapes and dtypes
at full size (a JAX trace, no compile), the kernel wrappers take CUDA
tensors only, the parameter conversion checks what it is given, the MoE
capacity and combine, and the one-token recurrent step equals the
reference's."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro_torch.configs import base, registry  # noqa: E402
from repro_torch.convert import model_params_from_numpy  # noqa: E402
from repro_torch.kernels import build, flash_attention, ops  # noqa: E402
from repro_torch.kernels import rwkv6_scan, ssm_scan  # noqa: E402
from repro_torch.models import linear_rnn as R  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402


@pytest.mark.parametrize("arch", jreg.ARCHS)
def test_configs_equal_the_reference(arch):
    assert registry.ARCHS == jreg.ARCHS
    for port, ref in ((registry.get_config(arch), jreg.get_config(arch)),
                      (registry.smoke_config(arch), jreg.smoke_config(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count == ref.param_count
        assert port.active_param_count == ref.active_param_count
        assert base.applicable_shapes(port) == jbase.applicable_shapes(ref)
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "moonshot-v1-16b-a3b",
                                  "whisper-large-v3", "qwen2-vl-72b"])
def test_new_families_hold_the_reference_params(arch):
    """At full size: the port's parameters (``first_layers``, ``encoder``,
    ``patch_proj`` and the rest) are the reference's tree, unstacked, leaf
    for leaf in shape and dtype."""
    import jax
    from repro.models.model import build_model as jax_build_model
    cfg = registry.get_config(arch)
    shapes = jax.eval_shape(lambda k: jax_build_model(cfg).init(k)[0],
                            jax.random.PRNGKey(0))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        parts = [str(k.key) for k in path]
        if parts[0] in ("layers", "first_layers", "encoder"):
            for i in range(leaf.shape[0]):
                want[".".join([parts[0], str(i), *parts[1:]])] = (
                    tuple(leaf.shape[1:]), str(leaf.dtype))
        else:
            want[".".join(parts)] = (tuple(leaf.shape), str(leaf.dtype))
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in Model(cfg, device="meta").state_dict().items()}
    assert got == want


def moe_cfg(**over):
    return dataclasses.replace(registry.get_config("moonshot-v1-16b-a3b"),
                               **over)


@pytest.mark.parametrize("s,cap", [(1, 6), (2, 8), (2048, 256), (4096, 512),
                                   (100, 16), (16, 8)])
def test_moe_capacity_rounds_as_the_reference(s, cap):
    """cf * s * k / E (moonshot: 1.25, top 6 of 64): decode min(8, k);
    below 128 up to a multiple of 8 (100 tokens: 11 -> 16); from 128 on up
    to a multiple of 128 (2048: 240 -> 256); at most s * k."""
    assert M.capacity(moe_cfg(), s) == cap
    assert M.capacity(moe_cfg(top_k=2, n_experts=8), 1) == 2
    assert M.capacity(moe_cfg(n_experts=4, top_k=2), 3) == 6


def test_moe_combine_is_the_same_on_every_call():
    """Two calls on the same input give bit-equal outputs, and each token's
    slots are added in slot order: the output equals a sequential
    scatter-add over the slots (the reference's combine)."""
    cfg = dataclasses.replace(registry.smoke_config("moonshot-v1-16b-a3b"),
                              dtype="float32", capacity_factor=0.6)
    g = torch.Generator().manual_seed(4)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    p = {"router": torch.randn(d, e, generator=g) / d ** 0.5,
         "wi": torch.randn(e, d, f, generator=g) / d ** 0.5,
         "wg": torch.randn(e, d, f, generator=g) / d ** 0.5,
         "wo": torch.randn(e, f, d, generator=g) / f ** 0.5}
    x = torch.randn(3, 40, d, generator=g)
    y1, aux1 = M.moe_ffn(p, x, cfg)
    y2, aux2 = M.moe_ffn(p, x, cfg)
    assert torch.equal(y1.view(torch.int32), y2.view(torch.int32))
    assert torch.equal(aux1, aux2)
    r, _ = M.route(p, x, cfg)
    assert not bool(r.kept.all())       # the capacity drops some choices
    xe = torch.gather(x, 1, r.tok_of_slot[..., None].expand(-1, -1, d))
    xe = xe * (r.gate_of_slot > 0)[..., None]
    h = torch.einsum("bsd,bsdf->bsf", xe,
                     p["wi"].repeat_interleave(r.cap, 0)[None])
    gg = torch.einsum("bsd,bsdf->bsf", xe,
                      p["wg"].repeat_interleave(r.cap, 0)[None])
    ye = torch.einsum("bsf,bsfd->bsd", torch.nn.functional.silu(gg) * h,
                      p["wo"].repeat_interleave(r.cap, 0)[None])
    want = torch.zeros_like(x)
    for bi in range(x.shape[0]):
        for slot in range(e * r.cap):
            want[bi, r.tok_of_slot[bi, slot]] += (
                ye[bi, slot] * r.gate_of_slot[bi, slot])
    torch.testing.assert_close(y1, want, atol=1e-5, rtol=1e-5)


def test_kernel_wrappers_take_cuda_tensors_only():
    """The wrappers raise on a CPU tensor before building anything; ``ops``
    sends it to the plain version, and refuses a device with neither."""
    q = torch.randn(4, 64, 16)
    w = torch.rand(4, 64, 16) * 0.5 + 0.4
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        rwkv6_scan.gla_scan(q, q, q, w, torch.randn(4, 16), mode="k")
    with pytest.raises(ValueError, match="CUDA"):
        ssm_scan.ssd_scan(q, q, q, w)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))
    for name, fns in (("flash_attention", ["launch_flash_attention"]),
                      ("rwkv6_scan", ["launch_gla_scan", "gla_smem_bytes",
                                      "gla_max_smem", "gla_tc_smem_bytes",
                                      "gla_tc_blocks_per_sm",
                                      "gla_ssd_smem_bytes",
                                      "gla_ssd_blocks_per_sm"])):
        assert sorted(build._SIGNATURES[name]) == sorted(fns)
        assert (build.CSRC / f"{name}.cu").exists()
    assert flash_attention.LAUNCHES == {"flash_attention": 0}
    assert rwkv6_scan.LAUNCHES == {"rwkv6_scan": 0, "ssd_scan": 0}


def test_plain_kernels_refuse_what_the_kernels_refuse():
    q = torch.randn(2, 48, 8)
    w = torch.rand(2, 48, 8) * 0.5 + 0.4
    with pytest.raises(ValueError, match="does not divide"):
        ops.ssd_scan(q, q, q, w, chunk=40)
    with pytest.raises(ValueError, match="mode"):
        ops._ref.gla_scan(q, q, q, w, mode="x")
    with pytest.raises(ValueError, match="tile"):
        ops.rwkv6_scan(q, q, q, w, torch.randn(3, 8), chunk=16)
    assert [R._chunk(s, 64) for s in (48, 64, 100, 2048, 97)] == [
        48, 64, 50, 64, 1]


def test_param_conversion_checks_names_shapes_and_dtypes():
    cfg = dataclasses.replace(registry.smoke_config("rwkv6-7b"),
                              dtype="float32")
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    flat = {}
    for name, p in model.state_dict().items():
        parts = name.split(".")
        if parts[0] == "layers":
            key = "/".join(["layers", *parts[2:]])
            flat.setdefault(key, [None] * cfg.n_layers)[int(parts[1])] = (
                p.numpy())
        else:
            flat["/".join(parts)] = p.numpy()
    flat = {k: np.stack(v) if isinstance(v, list) else v
            for k, v in flat.items()}
    back = model_params_from_numpy(cfg, flat)
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())
    with pytest.raises(ValueError, match="missing"):
        model_params_from_numpy(cfg, {k: v for k, v in flat.items()
                                      if k != "final_norm"})
    bad = dict(flat, final_norm=flat["final_norm"][:-1])
    with pytest.raises(ValueError, match="final_norm"):
        model_params_from_numpy(cfg, bad)
    bad = dict(flat, final_norm=flat["final_norm"].astype(np.float64))
    with pytest.raises(ValueError, match="final_norm"):
        model_params_from_numpy(cfg, bad)


def test_init_draws_the_reference_scales():
    """Fills where the reference fills, normal draws at its scales."""
    cfg = dataclasses.replace(registry.smoke_config("hymba-1.5b"),
                              d_model=256, d_ff=512)
    m = Model(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    sd = m.state_dict()
    assert sd["layers.0.attn.wq"].dtype == torch.bfloat16
    assert sd["layers.1.ssd.a_log"].eq(0).all()
    assert sd["layers.1.ssd.dt_bias"].eq(-1).all()
    assert sd["final_norm"].eq(1).all()
    for name, std in (("layers.0.mlp.wi", 1 / 16), ("layers.0.ssd.wdt", 0.01),
                      ("embed.tok", 1 / 16),
                      ("layers.1.attn.wo", 1 / (cfg.n_heads * 16) ** 0.5)):
        assert abs(float(sd[name].float().std()) / std - 1) < 0.1, name


@pytest.mark.parametrize("mode", ["k", "v"])
def test_gla_decode_step_matches_jax_and_gla_ref(mode):
    """One recurrent step from a nonzero state, the JAX step run eagerly."""
    import jax.numpy as jnp
    from repro.models import linear_rnn as JR
    rng = np.random.default_rng(17)
    b, h, dk, dv = 2, 3, 8, 16
    q, k = (rng.standard_normal((b, h, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, h, dv)).astype(np.float32)
    w = rng.uniform(0.5, 0.95, (b, h, dk if mode == "k" else dv)).astype(
        np.float32)
    state = rng.standard_normal((b, h, dk, dv)).astype(np.float32)
    bonus = rng.standard_normal((h, dk)).astype(np.float32) if mode == "k" \
        else None
    t = torch.from_numpy
    out, st = R.gla_decode_step(t(q), t(k), t(v), t(w), t(state),
                                None if bonus is None else t(bonus), mode)
    jout, jst = JR.gla_decode_step(*map(jnp.asarray, (q, k, v, w, state)),
                                   None if bonus is None
                                   else jnp.asarray(bonus), mode)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=1e-6,
                               atol=1e-6)
    rout, rst = R.gla_ref(*(x[:, None] for x in map(t, (q, k, v, w))),
                          None if bonus is None else t(bonus), mode,
                          s0=t(state))
    assert torch.allclose(rout[:, 0], out) and torch.allclose(rst, st)
