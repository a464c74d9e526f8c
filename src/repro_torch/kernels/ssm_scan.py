"""The SSD (Mamba2-style) scan of hymba's SSM heads: mode "v" of the CUDA
gated-linear-attention kernel (``csrc/rwkv6_scan.cu``).

Counterpart of ``repro.kernels.ssm_scan.ssd_pallas``; its launches count as
``rwkv6_scan.LAUNCHES["ssd_scan"]``.
"""
from __future__ import annotations

from repro_torch.kernels.rwkv6_scan import gla_scan


def ssd_scan(q, k, v, w, *, chunk: int = 64):
    """q = C, k = B (BH, S, state), v (BH, S, head), w (BH, S, head) decay:
    (out, final state) as ``gla_scan(mode="v")``."""
    return gla_scan(q, k, v, w, mode="v", chunk=chunk)
