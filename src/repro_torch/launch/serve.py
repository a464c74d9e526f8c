"""Serving launcher of the port: batched requests through the ServeEngine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
        --full --prompt-len 2048
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch moonshot-v1-16b-a3b --device cpu

The flags of ``repro.launch.serve``, plus ``--device`` (the CUDA card
unless ``--device cpu``) and ``--seed`` (the random weights and prompts).
The weights are random, drawn at the config's shapes on the device; the
prompts are 12 random tokens each. Prints the ``[serve] ... tok/s`` line.
As in the reference, the engine passes tokens only: an encdec model
(whisper) needs its ``frames`` and is driven through ``Model.prefill_fn``
and ``decode_fn`` instead.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs.registry import ARCHS, get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b", choices=ARCHS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, cache_headroom=args.max_new)
    model = build_model(cfg, device).init(
        torch.Generator(device=device).manual_seed(args.seed))
    eng = ServeEngine(model, batch_slots=args.batch_slots,
                      prompt_len=args.prompt_len,
                      temperature=args.temperature, seed=args.seed,
                      device=device)
    g = torch.Generator().manual_seed(args.seed + 1)
    reqs = [Request(rid=i, tokens=torch.randint(1, cfg.vocab, (12,),
                                                generator=g).tolist(),
                    max_new=args.max_new) for i in range(args.requests)]

    done = 0
    t0 = time.perf_counter()
    for i in range(0, len(reqs), args.batch_slots):
        batch = reqs[i:i + args.batch_slots]
        eng.run(batch, max_ticks=args.max_new + 2)
        done += sum(r.done for r in batch)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.out) for r in reqs)
    print(f"[serve] {done}/{len(reqs)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens / dt:.1f} tok/s) on {device}")
    for r in reqs[:3]:
        print(f"  req {r.rid}: {r.out}")
    return dict(done=done, requests=len(reqs), tokens=total_tokens,
                seconds=dt)


if __name__ == "__main__":
    main()
