"""Dot FLOPs and dot bytes of a torch program, the counterpart of
``repro.roofline.hlocount.stablehlo_costs``.

The reference walks the StableHLO text of a lowered program and sums, for
every ``stablehlo.dot_general``, 2 x output elements x contracted elements
FLOPs and the bytes of its two operands and its result, multiplying a loop
body's cost by its trip count. The port has no HLO. :class:`DotCounter` is a
``TorchDispatchMode`` that sees every aten op the program runs and counts
the same two numbers for each matrix product (``mm``, ``addmm``, ``bmm``,
``baddbmm``, ``mv``, ``dot``; ``einsum``, ``matmul`` and ``linear`` reach the
dispatcher as these). The bias of ``addmm``/``baddbmm`` is not an operand of
the product and is not counted, as a dot_general has none.

Run the program on ``meta`` tensors: nothing is allocated and nothing is
computed, so a step at production size is counted in seconds on any host.
``kernels.ops`` sends a meta tensor to the plain version of each kernel,
and the model takes the reference's form where the plain version's
products differ from it (``layers.attention``, ``linear_rnn.gla_chunked``),
so the count reads the work of the reference's program whatever runs it.
Eager execution unrolls every loop (the layers, the attention's key chunks,
the scans' chunks, the loss's sequence chunks), so no trip count is parsed:
each iteration's products are counted as they run. ``tests/test_torch_
roofline.py`` holds this against the reference's own cases: a 30-step scan
of (8, 256) @ (256, 256) counts exactly 30 x 2 x 8 x 256 x 256 FLOPs, and
its gradient under a per-step checkpoint exactly 4 x that (forward,
recomputed forward, two products backward).

``DotCounter`` also keeps ``by_op`` (op name -> [FLOPs, bytes]).
"""
from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_aten = torch.ops.aten


def _numel(shape) -> int:
    return math.prod(int(d) for d in shape)


def _bytes(t: torch.Tensor) -> int:
    return _numel(t.shape) * t.element_size()


def _mm(a, b, out_shape):
    """(FLOPs, bytes) of a product of a and b whose contracted
    dimension is a's last."""
    flops = 2 * _numel(out_shape) * max(int(a.shape[-1]), 1)
    out_bytes = _numel(out_shape) * a.element_size()
    return flops, _bytes(a) + _bytes(b) + out_bytes


def _cost(func, args):
    """(FLOPs, bytes) of one matrix product, None for any other op."""
    op = func.overloadpacket
    if op in (_aten.mm, _aten.bmm):
        a, b = args[0], args[1]
        return _mm(a, b, (*a.shape[:-1], b.shape[-1]))
    if op in (_aten.addmm, _aten.baddbmm):
        a, b = args[1], args[2]
        return _mm(a, b, (*a.shape[:-1], b.shape[-1]))
    if op is _aten.mv:
        a, b = args[0], args[1]
        return _mm(a, b, a.shape[:-1])
    if op is _aten.dot:
        a, b = args[0], args[1]
        return _mm(a, b, ())
    return None


class DotCounter(TorchDispatchMode):
    """Counts the matrix products run inside the block: ``flops`` and
    ``dot_bytes`` (ints), as :func:`repro.roofline.hlocount.stablehlo_costs`
    counts a program's dot_generals."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.dot_bytes = 0
        self.by_op: dict[str, list[int]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        cost = _cost(func, args)
        if cost is not None:
            flops, nbytes = cost
            self.flops += flops
            self.dot_bytes += nbytes
            tot = self.by_op.setdefault(func.overloadpacket.__name__, [0, 0])
            tot[0] += flops
            tot[1] += nbytes
        return func(*args, **(kwargs or {}))

    def costs(self) -> dict:
        """``{"flops", "dot_bytes"}``, the reference's keys."""
        return {"flops": self.flops, "dot_bytes": self.dot_bytes}
