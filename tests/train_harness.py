"""What the training tests share: a seeded batch for a smoke config, the
reference's loss, gradients and one AdamW step at a model's params (one
compiled ``value_and_grad``), the port's at the same params, and the
comparison of the two, leaf by leaf, at the stated tolerances."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.train.optimizer import adamw_update as jax_adamw
from repro.train.optimizer import init_opt_state as jax_init_opt
from repro_torch.configs.base import TrainConfig
from repro_torch.convert import model_params_to_numpy
from repro_torch.train import optimizer as topt
from repro_torch.train.loop import loss_and_grads

from zoo_harness import flat_params, models

# loss and aux: the model zoo's tolerance
LOSS_TOL = dict(atol=1e-4, rtol=1e-4)
# gradients, first moments: per leaf, atol 1e-4 of the leaf's largest
# reference magnitude, rtol 1e-3
REL_ATOL, RTOL = 1e-4, 1e-3
# second moments (g squared): twice the gradients' relative tolerances.
# One step at lr 1e-3 without warmup: AdamW moves each element by lr times
# g / (|g| + eps) + wd * p, about lr in the sign of the clipped g. Where the
# reference's |g| is UPDATE_MARGIN times the gradients' tolerance and 1e3
# eps (clipped), that sign and size are fixed: the update p1 - p0 is held to
# UPDATE_RTOL * lr plus 4 float32 spacings of p (p0's and p1's rounding).
# Elsewhere the sign is not fixed and the update is held to 2 lr.
TC = dict(learning_rate=1e-3, warmup_steps=1)
UPDATE_MARGIN, UPDATE_RTOL = 10.0, 1e-3


def train_batch(cfg, seed: int = 0, b: int = 2, s: int = 64) -> dict:
    """numpy inputs and targets for a smoke config, the first three targets
    of row 0 masked (-1); encdec: 64 frames and 8 decoder tokens; vlm: 16
    patch embeddings and the same positions three times."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        tok = rng.integers(0, cfg.vocab, (b, 8)).astype(np.int32)
        batch = {"frames": rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32), "tokens": tok}
    else:
        tok = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
        batch = {"tokens": tok}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (b, 16, cfg.d_model)).astype(np.float32)
        pos = np.arange(s, dtype=np.int32)[None].repeat(b, 0)
        batch["positions3"] = np.stack([pos, pos, pos])
    targets = np.roll(tok, -1, axis=1)
    targets[0, :3] = -1
    batch["targets"] = targets
    return batch


_COMPILED = {}


def reference_step(jm, params, batch: dict) -> dict:
    """The reference's loss, metrics, gradients and one AdamW step, as
    numpy (trees flattened to ``layers/attn/wq`` paths). Each config's
    ``value_and_grad`` and step compile once per process."""
    if jm.cfg not in _COMPILED:
        _COMPILED[jm.cfg] = (
            jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True)),
            jax.jit(jax_adamw, static_argnums=3))
    vg, adamw = _COMPILED[jm.cfg]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, met), grads = vg(params, jb)
    p2, o2, om = adamw(params, grads, jax_init_opt(params),
                       JaxTrainConfig(**TC))
    return dict(loss=float(loss), aux=float(met["aux"]),
                tokens=float(met["tokens"]), grads=flat_params(grads),
                p0=flat_params(params), params=flat_params(p2),
                m=flat_params(o2.m),
                v=flat_params(o2.v), grad_norm=float(om["grad_norm"]))


def port_step(tm, batch: dict, **tc) -> dict:
    """The port's loss, metrics and gradients, then one AdamW step, as
    numpy in the reference's layout."""
    tm.requires_grad_(True)
    params = dict(tm.named_parameters())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, met, grads = loss_and_grads(tm, params, tb)
    out = dict(loss=float(loss), aux=float(met["aux"]),
               tokens=float(met["tokens"]),
               grads=model_params_to_numpy(grads))
    opt = topt.init_opt_state(params)
    _, opt, om = topt.adamw_update(params, grads, opt,
                                   TrainConfig(**{**TC, **tc}))
    out.update(params=model_params_to_numpy(params),
               m=model_params_to_numpy(opt.m), v=model_params_to_numpy(opt.v),
               grad_norm=float(om["grad_norm"]))
    return out


def assert_leaves_close(want: dict, got: dict, name: str, *,
                        rel_atol: float, rtol: float, atol: float = 0.0):
    """The same leaves, each within atol + rel_atol * max|want| + rtol *
    |want| of the reference."""
    assert sorted(want) == sorted(got), name
    for k, a in want.items():
        b = got[k]
        assert b.shape == a.shape, (name, k)
        tol = atol + rel_atol * float(np.abs(a).max(initial=0.0))
        np.testing.assert_allclose(b, a, atol=tol, rtol=rtol,
                                   err_msg=f"{name} {k}")


def assert_step_close(want: dict, got: dict, lr: float = TC["learning_rate"]):
    """Loss, aux, token count, gradients, moments and parameters after one
    AdamW step of the port within the stated tolerances of the
    reference's."""
    for key in ("loss", "aux", "grad_norm"):
        np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                   **LOSS_TOL)
    assert got["tokens"] == want["tokens"]
    assert_leaves_close(want["grads"], got["grads"], "grad",
                        rel_atol=REL_ATOL, rtol=RTOL)
    assert_leaves_close(want["m"], got["m"], "m", rel_atol=REL_ATOL,
                        rtol=RTOL)
    assert_leaves_close(want["v"], got["v"], "v", rel_atol=2 * REL_ATOL,
                        rtol=2 * RTOL)
    assert_update_close(want, got["params"], lr)


def assert_update_close(want: dict, got_params: dict,
                        lr: float = TC["learning_rate"],
                        eps: float = JaxTrainConfig.eps) -> int:
    """The port's parameters after one AdamW step, as the update from the
    reference's ``p0``: within UPDATE_RTOL * lr (plus p's rounding) of the
    reference's update where the reference's gradient fixes its sign, and
    within 2 lr everywhere. Returns how many elements were held tight, and
    asserts that they are most of them."""
    assert sorted(want["params"]) == sorted(got_params)
    clip = min(1.0, JaxTrainConfig.grad_clip / max(want["grad_norm"], 1e-9))
    n_tight = n_all = 0
    for k, p1 in want["params"].items():
        p0, g = want["p0"][k], want["grads"][k]
        u_want, u_got = p1 - p0, got_params[k] - p0
        tol_g = REL_ATOL * float(np.abs(g).max(initial=0.0)) \
            + RTOL * np.abs(g)
        tight = (np.abs(g) > UPDATE_MARGIN * tol_g) \
            & (np.abs(g) * clip > 1e3 * eps)
        err = np.abs(u_got - u_want)
        bound = UPDATE_RTOL * lr + 4 * np.spacing(np.abs(p0))
        assert (err[tight] <= bound[tight]).all(), (
            f"params {k}: update off by {float(err[tight].max())}")
        assert (err <= 2 * lr).all(), f"params {k}: {float(err.max())}"
        n_tight += int(tight.sum())
        n_all += err.size
    assert n_tight > n_all // 2, (n_tight, n_all)
    return n_tight


def compare_arch(arch: str, seed: int = 0, **over) -> dict:
    """Reference and port at one smoke config in float32 (the same params
    and batch); asserts :func:`assert_step_close` and returns both with the
    reference model and params."""
    jm, params, tm = models(arch, seed, **over)
    batch = train_batch(jm.cfg, seed)
    want, got = reference_step(jm, params, batch), port_step(tm, batch)
    assert_step_close(want, got)
    return dict(want=want, got=got, jm=jm, params=params, batch=batch)
