"""Training launcher of the port:

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --full --steps 30
    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \
        --steps 20 --device cpu

The flags of ``repro.launch.train``, plus ``--device`` (the CUDA card unless
``--device cpu``; without a card the launcher raises, it never falls back to
the CPU). Trains the reduced config (``--smoke``, the default) or the
published one (``--full``) on random weights from ``TrainConfig.seed`` over
the synthetic token stream of ``data.pipeline``, and prints the mean loss of
the first ten steps and of the last ten. For encdec (whisper) the encoder's
frames are drawn once, from a ``torch.Generator`` seeded with 0 on the CPU:
standard normal values of the same shape as the reference launcher's
``jax.random.normal`` draw, not the same values.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import ARCHS, get_config, smoke_config
from repro_torch.data import pipeline as dp
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.train.loop import train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=ARCHS)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="reduced same-family config")
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device)
    tc = TrainConfig(learning_rate=args.lr, warmup_steps=20,
                     microbatches=args.microbatches)
    dcfg = dp.DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                         global_batch=args.global_batch)
    extra = None
    if cfg.family == "encdec":
        g = torch.Generator().manual_seed(0)
        extra = {"frames": torch.randn(args.global_batch, args.seq_len,
                                       cfg.d_model, generator=g)}
        dcfg = dp.DataConfig(vocab=cfg.vocab, seq_len=cfg.decoder_len,
                             global_batch=args.global_batch)
    _, _, history = train(model, tc, steps=args.steps, data_cfg=dcfg,
                          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                          extra_batch=extra)
    first = sum(history[:10]) / max(len(history[:10]), 1)
    last = sum(history[-10:]) / max(len(history[-10:]), 1)
    print(f"[train] done: first-10 loss {first:.4f} -> last-10 loss "
          f"{last:.4f} on {device}")
    return dict(history=history, first10=first, last10=last)


if __name__ == "__main__":
    main()
