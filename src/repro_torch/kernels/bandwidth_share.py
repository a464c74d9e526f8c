"""Wrapper of the CUDA max-min water-fill (``csrc/bandwidth_share.cu``).

Counterpart of ``repro.kernels.bandwidth_share.maxmin_rates_pallas``, over a
leading lane dimension. The wrapper checks device, dtype, shape and
contiguity, allocates the output with ``torch.empty``, launches on the
current stream, raises if the launch was refused or the shape exceeds what
the kernel takes, and adds one to :data:`LAUNCHES`. It takes CUDA tensors
only; ``ops`` sends CPU tensors to the plain version in ``ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import LEFT_TO_RIGHT, FlowOrder

# The launch count: the proof that a run went through the kernel.
LAUNCHES = {"maxmin_rates": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(name: str, x: torch.Tensor, dtype, shape) -> None:
    if not x.is_cuda or x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous():
        raise ValueError(f"maxmin_rates: {name} must be a contiguous CUDA "
                         f"{dtype} {tuple(shape)} tensor, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def _pack_order(order: FlowOrder, n_flows: int, max_blocks: int) -> int:
    """Check a flow-sum order against what the kernel takes; return its
    block order as 4-bit fields of one unsigned 64-bit integer."""
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
    return sum(b << (4 * k) for k, b in enumerate(blocks))


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
    lib = build.library("bandwidth_share")
    if lib.maxmin_smem_bytes(F, L) > lib.maxmin_max_smem():
        raise ValueError(
            f"maxmin_rates: {F} flows over {L} links need "
            f"{lib.maxmin_smem_bytes(F, L)} B of shared memory; one block "
            f"holds {lib.maxmin_max_smem()}")
    packed = _pack_order(order, F, lib.maxmin_max_order_blocks())
    out = torch.empty((B, F), dtype=torch.float32, device=inc.device)
    err = lib.launch_maxmin_rates(
        inc.data_ptr(), bw.data_ptr(), active.data_ptr(), out.data_ptr(), B,
        F, L, order.head, packed, order.chains, order.tail_lanes,
        order.trailing, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"maxmin_rates: CUDA launch failed with error "
                           f"{err}")
    LAUNCHES["maxmin_rates"] += 1
    return out
