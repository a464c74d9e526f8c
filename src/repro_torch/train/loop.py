"""The training step and driver of the model zoo, the counterpart of
``repro.train.loop``: microbatched gradient accumulation in float32,
optional int8 gradient compression, AdamW, checkpoint/restart and the
straggler monitor.

A tree of parameters is the model's own, ``dict(model.named_parameters())``:
``Model.loss_fn`` reads them from the module, and the step updates them in
place. The gradients are ``torch.autograd.grad`` of the loss, zeros for a
parameter the loss does not reach (as the reference's, whose gradient tree
holds every leaf).
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import TrainConfig
from repro_torch.data import pipeline as dp
from repro_torch.ft.straggler import StragglerMonitor
from repro_torch.models.model import Model
from repro_torch.train import compression as comp
from repro_torch.train import optimizer as opt

_F32 = torch.float32


def _split(batch: dict, n: int, i: int) -> dict:
    """Microbatch i of n: the leading batch axis cut in n, ``positions3``
    (3, b, s) on its second axis."""
    def part(k, x):
        x = torch.as_tensor(x)
        ax = 1 if k == "positions3" else 0
        per = x.shape[ax] // n
        return x.narrow(ax, i * per, per)
    return {k: part(k, v) for k, v in batch.items()}


def loss_and_grads(model: Model, params: dict, batch: dict):
    """(loss, metrics, grads) of one forward and backward, all detached."""
    loss, metrics = model.loss_fn(batch)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(params, grads)))


def make_train_step(model: Model, tc: TrainConfig,
                    total_steps: int = 10_000) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics), params
    the model's own (updated in place). Turns the model's gradients on.

    With ``tc.microbatches`` n > 1 the batch is cut in n along its leading
    axis and the gradients are summed in float32, then divided by n; the
    loss is the mean of the microbatches' and the loss function's metrics
    are dropped, as the reference's. With ``tc.compress_grads`` the
    gradients take the int8 round trip (no carried error) before AdamW."""
    model.requires_grad_(True)

    def step(params: dict, opt_state: opt.OptState, batch: dict):
        n = tc.microbatches
        if n > 1:
            g_sum = {k: torch.zeros(p.shape, dtype=_F32, device=p.device)
                     for k, p in params.items()}
            loss_sum = 0.0
            for i in range(n):
                loss, _, g = loss_and_grads(model, params, _split(batch, n, i))
                for k, v in g.items():
                    g_sum[k] += v.float()
                loss_sum = loss_sum + loss
            grads = {k: g / n for k, g in g_sum.items()}
            loss, metrics = loss_sum / n, {}
        else:
            loss, metrics, grads = loss_and_grads(model, params, batch)
        if tc.compress_grads:
            q, _ = comp.compress_tree(grads, comp.init_error_fb(grads))
            grads = comp.decompress_tree(q)
        params, opt_state, om = opt.adamw_update(params, grads, opt_state,
                                                 tc, total_steps)
        om["loss"] = loss
        return params, opt_state, {**metrics, **om}

    return step


def train(model: Model, tc: TrainConfig, *, steps: int,
          data_cfg: dp.DataConfig, ckpt_dir: str | None = None,
          ckpt_every: int = 100, log_every: int = 10,
          extra_batch: dict | None = None):
    """Single-host training: random weights from ``tc.seed`` (a generator
    on the model's device), AdamW state, then steps ``start`` .. ``steps`` -
    1 over the data stream, a checkpoint of (params, opt_state) every
    ``ckpt_every`` steps, each step's seconds to a ``StragglerMonitor``.
    Returns (params, opt_state, the losses of the steps run).

    A checkpoint saved after step s carries the label s, as the
    reference's, and a restart resumes at step s + 1: the reference resumes
    at s and runs batch s a second time, the port does not, so a stopped
    and resumed run equals an unbroken one."""
    dev = model.device
    model.init(torch.Generator(device=dev).manual_seed(tc.seed))
    params = dict(model.named_parameters())
    opt_state = opt.init_opt_state(params, tc.opt_dtype)
    start = 0
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    if ckpt and ckpt.latest_step() is not None:
        saved, (p, o) = ckpt.restore((params, opt_state))
        with torch.no_grad():
            for k, v in p.items():
                params[k].copy_(v)
        opt_state = o
        start = saved + 1
        print(f"[train] restored step {saved}")

    step_fn = make_train_step(model, tc, total_steps=steps)
    monitor = StragglerMonitor(n_hosts=1)
    history = []
    for step, batch in dp.batch_iterator(data_cfg, start_step=start):
        if step >= steps:
            break
        if extra_batch:
            batch = {**batch, **extra_batch}
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        monitor.record(host=0, step=step, seconds=dt)
        history.append(loss)
        if step % log_every == 0:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")
        if ckpt and step > start and step % ckpt_every == 0:
            ckpt.save(step, (params, opt_state))
    if ckpt:
        ckpt.wait()
    return params, opt_state, history
