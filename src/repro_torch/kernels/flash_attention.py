"""Wrapper of the CUDA flash attention (``csrc/flash_attention.cu``).

Counterpart of ``repro.kernels.flash_attention.flash_attention`` on its
(BH, S, D) layout. bfloat16 runs the tensor-core kernel (wgmma from a
TMA-filled K/V ring; 16-byte aligned tensors), float32 the FFMA kernel; the
source picks by dtype. The wrapper checks device, dtype, shape and
contiguity, allocates the output with ``torch.empty``, launches on the
current stream, raises if the launch was refused or the kernel does not take
the shape, and adds one to :data:`LAUNCHES`. It takes CUDA tensors only;
``ops`` sends CPU tensors to the plain version in ``ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

# The launch count: the proof that a run went through the kernel.
LAUNCHES = {"flash_attention": 0}

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (BH, Sq, D), k and v (BKV, Skv, D), one dtype (float32 or
    bfloat16), D in :data:`HEAD_DIMS`, BH % BKV == 0 (row bh attends KV row
    bh // (BH // BKV)); ``causal`` lets query row q attend keys 0 .. q (no
    offset, as the reference's mask, for any Sq and Skv), ``window`` > 0
    keeps the last ``window`` of them. Returns (BH, Sq, D) in q's dtype."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda or x.dtype != q.dtype or x.ndim != 3 \
                or not x.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"3-D CUDA tensor of q's dtype, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not in "
                         f"{list(DTYPES)}")
    bh, sq, d = q.shape
    bkv, skv, _ = k.shape
    if (tuple(v.shape) != (bkv, skv, d) or k.shape[2] != d
            or min(bh, sq, bkv, skv) < 1 or bh % bkv):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not "
                         f"match (BH, Sq, D), (BKV, Skv, D) with BH % BKV "
                         f"== 0")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    lib = build.library("flash_attention")
    out = torch.empty_like(q)
    err = lib.launch_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, bkv,
        sq, skv, d, int(causal), int(window), DTYPES[q.dtype],
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA launch failed with error "
                           f"{err}")
    LAUNCHES["flash_attention"] += 1
    return out
