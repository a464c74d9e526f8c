#!/usr/bin/env python3
"""Device times of the port's ``group_by_kind`` and ``route_rank`` kernels at
the engine's shapes, to compare two trees on one card.

    python3 tools/rank_kernel_times.py [--src DIR] [--label NAME] [--rounds N]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
builds its kernels there, and prints one line a kernel: the median, range
and rounds of its device time (``chip_smoke.device_ms``, torch.profiler)
over ``N`` rounds, ``group_by_kind`` at (8, 256) with 8 kinds and a bool
mask (the engine's call, through ``ops``) and ``route_rank`` at (8, 4096)
with 9 uniform buckets (phase 3's shapes). Each output is checked against
the plain version first. To compare two trees, run them in turns in one
session on the card (a, b, b, a). Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--src", default=str(ROOT / "src"))
    p.add_argument("--label", default="this tree")
    p.add_argument("--rounds", type=int, default=9)
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("rank_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    from chip_smoke import device_ms, smi
    from repro_torch.kernels import ops, ref

    g = torch.Generator().manual_seed(0)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g,
                             dtype=torch.int32).cuda()

    A, m, nk, n, nb = 8, 256, 8, 4096, 9
    kd, acb, dd = ri(0, nk, (A, m)), ri(0, 2, (A, m)).bool(), ri(0, nb, (A, n))
    cases = {
        "group_by_kind": (lambda: ops.group_by_kind(kd, acb, nk),
                          lambda: ref.group_by_kind(kd, acb, nk)),
        "route_rank": (lambda: ops.route_rank(dd, nb),
                       lambda: ref.route_rank(dd)),
    }
    for name, (fn, plain) in cases.items():
        got, want = fn(), plain()
        got, want = ((got,), (want,)) if torch.is_tensor(got) else (got, want)
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"{name} differs from its plain version")
        t = [device_ms(fn, f"{name}_kernel") for _ in range(args.rounds)]
        print(f"[{args.label}] {name} device ms: median "
              f"{sorted(t)[len(t) // 2]:.6f}, range {min(t):.6f}-"
              f"{max(t):.6f}, rounds {[round(x, 6) for x in t]}", flush=True)
    print(f"[{args.label}] {smi()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
