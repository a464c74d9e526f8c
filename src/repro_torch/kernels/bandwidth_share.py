"""Wrapper of the CUDA max-min water-fill (``csrc/bandwidth_share.cu``).

Counterpart of ``repro.kernels.bandwidth_share.maxmin_rates_pallas``, over a
leading lane dimension. Two kernels, picked in the source by (F, L) alone:
``maxmin_warp_kernel`` (a warp per lane) for F <= 32 and L <= 32, where the
flow order is always left to right, and ``maxmin_kernel`` (a CTA per lane)
for the rest. The wrapper checks device, dtype, shape and contiguity, checks
the flow order and the shared memory once per (F, L, order), allocates the
output with ``torch.empty`` (and, for a lane whose incidence does not fit
one block's shared memory, the kernel's global workspace), launches on the
current stream, raises if the launch was refused or the shape exceeds what
the kernel takes, and adds one to :data:`LAUNCHES` and to the kernel's
entry of :data:`KERNELS`. It takes CUDA tensors only; ``ops`` sends CPU
tensors to the plain version in ``ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import LEFT_TO_RIGHT, FlowOrder

# The launch count: the proof that a run went through the kernel.
LAUNCHES = {"maxmin_rates": 0}
# The same launches by the kernel that ran them.
KERNELS = {"maxmin_warp_kernel": 0, "maxmin_kernel": 0}


def reset_launches() -> None:
    for d in (LAUNCHES, KERNELS):
        for k in d:
            d[k] = 0


def _check(name: str, x: torch.Tensor, dtype, shape) -> None:
    if not x.is_cuda or x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous():
        raise ValueError(f"maxmin_rates: {name} must be a contiguous CUDA "
                         f"{dtype} {tuple(shape)} tensor, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def _pack_order(order: FlowOrder, n_flows: int,
                max_blocks: int) -> tuple[int, ...]:
    """Check a flow-sum order against what the kernel takes; return its
    block order as byte fields of ``max_blocks / 8`` unsigned 64-bit words
    (block k in byte k % 8 of word k // 8)."""
    V, blocks, chains, W, trailing = order
    n_blocks, tail = V // 8, n_flows - V - trailing
    ok = (V % 8 == 0 and 0 <= V <= n_flows and n_blocks <= max_blocks
          and sorted(blocks) == list(range(n_blocks)) and chains >= 1
          and W in (1, 2, 4, 8) and trailing >= 0 and tail >= 0)
    if V == 0:
        ok = ok and chains == 1 and W == 1 and trailing == 0
    else:
        ok = ok and n_blocks % chains == 0 and (
            W == 1 or (tail >= W and tail % W == 0))
    if not ok:
        raise ValueError(f"maxmin_rates: {order} is not a flow order the "
                         f"kernel takes for {n_flows} flows (at most "
                         f"{max_blocks} blocks of 8)")
    words = [0] * (max_blocks // 8)
    for k, b in enumerate(blocks):
        words[k // 8] |= b << (8 * (k % 8))
    return tuple(words)


@functools.lru_cache(maxsize=None)
def _plan(n_flows: int, n_links: int, order: FlowOrder):
    """The packed flow order (a ctypes array), the kernel and the floats of
    global workspace a lane takes for (F, L, order), checked once: the warp
    kernel sums left to right only, the block kernel's lane state must fit
    one block's shared memory (its incidence goes to the workspace where it
    does not)."""
    lib = build.library("bandwidth_share")
    n_words = lib.maxmin_max_order_blocks() // 8
    if lib.maxmin_takes_warp(n_flows, n_links):
        if order != LEFT_TO_RIGHT:
            raise ValueError(f"maxmin_rates: {n_flows} flows over {n_links} "
                             f"links run the warp kernel, which sums left "
                             f"to right only, got {order}")
        return (ctypes.c_ulonglong * n_words)(), "maxmin_warp_kernel", 0
    need = lib.maxmin_smem_bytes(n_flows, n_links)
    if need > lib.maxmin_max_smem():
        raise ValueError(
            f"maxmin_rates: {n_flows} flows over {n_links} links need {need} "
            f"B of shared memory; one block holds {lib.maxmin_max_smem()}")
    words = _pack_order(order, n_flows, lib.maxmin_max_order_blocks())
    return ((ctypes.c_ulonglong * n_words)(*words), "maxmin_kernel",
            lib.maxmin_work_floats(n_flows, n_links))


def maxmin_rates(inc: torch.Tensor, bw: torch.Tensor, active: torch.Tensor,
                 order: FlowOrder = LEFT_TO_RIGHT) -> torch.Tensor:
    """inc (B, F, L) float32 0/1, bw (B, L) float32, active (B, F) bool ->
    (B, F) float32 max-min fair rates, the per-link sums of frozen rates in
    flow ``order`` (``ref.flow_order`` gives the plain version's)."""
    if inc.ndim != 3:
        raise ValueError(f"maxmin_rates: inc must be (B, F, L), got "
                         f"{tuple(inc.shape)}")
    B, F, L = inc.shape
    if min(B, F, L) < 1:
        raise ValueError(f"maxmin_rates: empty input {(B, F, L)}")
    _check("inc", inc, torch.float32, (B, F, L))
    _check("bw", bw, torch.float32, (B, L))
    _check("active", active, torch.bool, (B, F))
    packed, kernel, work_floats = _plan(F, L, order)
    out = torch.empty((B, F), dtype=torch.float32, device=inc.device)
    work = (torch.empty(B * work_floats, dtype=torch.float32,
                        device=inc.device).data_ptr() if work_floats else None)
    err = build.library("bandwidth_share").launch_maxmin_rates(
        inc.data_ptr(), bw.data_ptr(), active.data_ptr(), out.data_ptr(),
        work, B, F, L, order.head, packed, order.chains, order.tail_lanes,
        order.trailing, torch._C._cuda_getCurrentRawStream(inc.get_device()))
    if err != 0:
        raise RuntimeError(f"maxmin_rates: CUDA launch failed with error "
                           f"{err}")
    LAUNCHES["maxmin_rates"] += 1
    KERNELS[kernel] += 1
    return out
