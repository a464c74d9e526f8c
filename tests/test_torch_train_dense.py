"""Training the port's dense family against the JAX package, in float32 on
the CPU: at each smoke config, the same params and batch (three targets
masked) through ``Model.loss_fn`` and its gradients, then one AdamW step
(lr 1e-3, no warmup), against the reference's compiled ``value_and_grad``
and ``adamw_update``. Tolerances (``train_harness``): loss, aux and the
global norm atol = rtol = 1e-4; gradients and first moments per leaf atol =
1e-4 * max|reference|, rtol = 1e-3; second moments twice that; the update
of the parameters 1e-3 * lr where the reference's gradient fixes its sign,
2 * lr elsewhere. Then two microbatches against the reference's one
batch, and the int8 round trip of the gradients.

Each reference configuration compiles once in this file, so it holds two
tests (ROADMAP.md, test budget)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.train import compression as jcomp  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.convert import model_params_to_numpy  # noqa: E402
from repro_torch.train import compression as comp  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train.loop import loss_and_grads, make_train_step  # noqa: E402
from train_harness import (LOSS_TOL, TC, assert_leaves_close,  # noqa: E402
                           assert_update_close, compare_arch, reference_step)
from zoo_harness import models  # noqa: E402


def _port_step(over: dict, batch: dict):
    """A fresh smollm-135m port model (the reference's params, seed 0), one
    ``make_train_step`` step over ``batch``: (params, opt, metrics) as
    numpy where a tree."""
    _, _, tm = models("smollm-135m")
    params = dict(tm.named_parameters())
    step = make_train_step(tm, TrainConfig(**TC, **over))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, opt, met = step(params, topt.init_opt_state(params), tb)
    assert int(opt.step) == 1
    return (model_params_to_numpy(params), model_params_to_numpy(opt.m),
            met)


def test_dense_smollm_step_microbatched_and_compressed():
    """smollm-135m against the reference; then, on the batch with no target
    masked (each row counts 64), the port's step with two microbatches (the
    rows apart, gradients summed in float32 and halved) against the
    reference's one-batch step: loss, global norm, first moments and
    parameters at the step's tolerances, and the loss function's metrics
    dropped as the reference drops them. Last, the int8 round trip of the
    port's gradients against the reference's of its own: within one int8
    level of each leaf (the rounding of an element near a half level can
    go either way), and a step with ``compress_grads`` runs."""
    ran = compare_arch("smollm-135m")
    batch = dict(ran["batch"])
    batch["targets"] = np.roll(batch["tokens"], -1, axis=1)
    want = reference_step(ran["jm"], ran["params"], batch)
    params, m, met = _port_step({"microbatches": 2}, batch)
    assert sorted(met) == ["grad_norm", "loss", "lr"]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(met[key]), want[key], err_msg=key,
                                   **LOSS_TOL)
    assert_leaves_close(want["m"], m, "m", rel_atol=1e-4, rtol=1e-3)
    assert_update_close(want, params)

    _, _, tm = models("smollm-135m")
    tp = dict(tm.requires_grad_(True).named_parameters())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, _, grads = loss_and_grads(tm, tp, tb)
    q, _ = comp.compress_tree(grads, comp.init_error_fb(grads))
    got = model_params_to_numpy(comp.decompress_tree(q))
    jg = {k: jax.numpy.asarray(v) for k, v in want["grads"].items()}
    jq, _ = jcomp.compress_tree(jg, {k: jax.numpy.zeros(v.shape)
                                     for k, v in jg.items()})
    ref = {k: np.asarray(v) for k, v in jcomp.decompress_tree(jq).items()}
    for k, a in ref.items():
        level = float(np.abs(want["grads"][k]).max()) / 127.0
        np.testing.assert_allclose(got[k], a, atol=1.01 * level, rtol=0,
                                   err_msg=k)
    _, _, met = _port_step({"compress_grads": True}, batch)
    assert np.isfinite(float(met["loss"]))


def test_dense_archs_step_as_the_reference():
    """deepseek-7b, codeqwen1.5-7b and starcoder2-3b (window 32, biases)."""
    for arch in ("deepseek-7b", "codeqwen1.5-7b", "starcoder2-3b"):
        compare_arch(arch)
