"""Wrapper of the CUDA chunked gated linear attention (``csrc/rwkv6_scan.cu``).

Counterpart of ``repro.kernels.rwkv6_scan.gla_pallas``: mode "k" is the
RWKV6 time mix (counted as ``rwkv6_scan``), mode "v" the SSD scan of
``ssm_scan`` (counted as ``ssd_scan``). bfloat16 runs a tensor-core kernel
(TF32 products): in mode "k" one 64-wide tile (dk and dv multiples of 8 up
to 64), in mode "v" one CTA per 16 columns of v (dk a multiple of 8 up to
64, dv a multiple of 8); both take a chunk up to 64 and inputs 16-byte
aligned. float32 runs the FFMA kernel. The wrapper checks device, dtype,
shape, contiguity and what the kernel takes, allocates the outputs with
``torch.empty``, launches on the current stream, raises if the launch was
refused or the shape needs more shared memory than a block has, and adds
one to the mode's entry of :data:`LAUNCHES`. It takes CUDA tensors only;
``ops`` sends CPU tensors to the plain version in ``ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

# Per-mode launch counts: the proof that a run went through the kernel.
LAUNCHES = {"rwkv6_scan": 0, "ssd_scan": 0}

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the tensor-core kernels' tile: the chunk and dk (and dv in mode "k") pad
# to it
TC_TILE = 64


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(name: str, x: torch.Tensor, dtype, shape) -> None:
    if not x.is_cuda or x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous():
        raise ValueError(f"gla_scan: {name} must be a contiguous CUDA "
                         f"{dtype} {tuple(shape)} tensor, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def _check_tc(q, k, v, w, dk: int, dv: int, c: int, mode: str) -> None:
    """What the tensor-core kernels take (bfloat16): mode "k" one tile of
    dk and dv, mode "v" dk up to the tile and dv in slices."""
    top = max(dk, dv) if mode == "k" else dk
    if dk % 8 or dv % 8 or max(top, c) > TC_TILE:
        what = "dk and dv" if mode == "k" else "dk"
        raise ValueError(f"gla_scan: bfloat16 mode {mode!r} takes dk and dv "
                         f"multiples of 8, {what} up to {TC_TILE}, and a "
                         f"chunk up to {TC_TILE}; got dk {dk}, dv {dv}, "
                         f"chunk {c}")
    if any(x.data_ptr() % 16 for x in (q, k, v, w)):
        raise ValueError(f"gla_scan: bfloat16 mode {mode!r} takes q, k, v "
                         f"and w 16-byte aligned")


def gla_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor | None = None, *,
             mode: str = "k", chunk: int = 64):
    """q, k (BH, S, dk) and v (BH, S, dv) of one dtype (float32 or
    bfloat16); w float32 (BH, S, dk) in mode "k", (BH, S, dv) in mode "v";
    u float32 (BH, dk) or None (mode "k" only). ``min(chunk, S)`` must
    divide S. Returns (out (BH, S, dv) in q's dtype, final state (BH, dk,
    dv) float32), from the zero state."""
    if mode not in ("k", "v"):
        raise ValueError(f"gla_scan: mode must be 'k' or 'v', got {mode!r}")
    if q.ndim != 3 or v.ndim != 3:
        raise ValueError(f"gla_scan: q and v must be 3-D, got "
                         f"{tuple(q.shape)} and {tuple(v.shape)}")
    bh, s, dk = q.shape
    dv = v.shape[-1]
    if q.dtype not in DTYPES:
        raise ValueError(f"gla_scan: dtype {q.dtype} not in {list(DTYPES)}")
    _check("q", q, q.dtype, (bh, s, dk))
    _check("k", k, q.dtype, (bh, s, dk))
    _check("v", v, q.dtype, (bh, s, dv))
    _check("w", w, torch.float32, (bh, s, dk if mode == "k" else dv))
    if u is not None:
        if mode != "k":
            raise ValueError("gla_scan: the bonus u is for mode 'k' only")
        _check("u", u, torch.float32, (bh, dk))
    c = min(chunk, s)
    if min(bh, s, dk, dv) < 1 or c < 1 or s % c:
        raise ValueError(f"gla_scan: chunk {chunk} does not divide the "
                         f"length of {tuple(q.shape)}")
    if q.dtype == torch.bfloat16:
        _check_tc(q, k, v, w, dk, dv, c, mode)
    lib = build.library("rwkv6_scan")
    if q.dtype == torch.float32:
        need = lib.gla_smem_bytes(dk, dv, c, int(mode == "k"))
        if need > lib.gla_max_smem():
            raise ValueError(f"gla_scan: dk {dk}, dv {dv}, chunk {c} need "
                             f"{need} B of shared memory; one block holds "
                             f"{lib.gla_max_smem()}")
    out = torch.empty((bh, s, dv), dtype=q.dtype, device=q.device)
    state = torch.empty((bh, dk, dv), dtype=torch.float32, device=q.device)
    err = lib.launch_gla_scan(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        None if u is None else u.data_ptr(), out.data_ptr(),
        state.data_ptr(), bh, s, dk, dv, c, int(mode == "k"),
        DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gla_scan: CUDA launch failed with error {err}")
    LAUNCHES["rwkv6_scan" if mode == "k" else "ssd_scan"] += 1
    return out, state
