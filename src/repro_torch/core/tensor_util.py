"""Tensor helpers that give PyTorch the XLA semantics the reference relies on.

* JAX scatters with ``mode="drop"`` discard out-of-range rows; ``index_put_``
  raises on the CPU and asserts on the card. :func:`scatter_rows` writes into
  one spare row that is sliced off afterwards.
* JAX gathers clamp out-of-range indices; :func:`gather_rows` and
  :func:`take` clamp explicitly.
* XLA converts float32 to int32 with saturation (NaN -> 0); a plain
  ``.to(torch.int32)`` differs between the CPU and the card. :func:`f2i`
  pins XLA's rule on both.
* XLA:CPU contracts ``c - a * b`` into one fused multiply-add. The port keeps
  float arithmetic in separate ops, except where the reference fuses:
  :func:`fms` computes that single rounding in float64 (the product of two
  float32 values is exact there).
"""
from __future__ import annotations

import torch

I32 = torch.int32
I32_MAX = 2**31 - 1
_F32_BELOW_2_31 = 2147483520.0   # largest float32 below 2**31


def arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=device)


def f2i(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 truncating toward zero, saturating, NaN -> 0 (XLA)."""
    big = x >= 2147483648.0
    y = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    y = y.clamp(-2147483648.0, _F32_BELOW_2_31).to(I32)
    return torch.where(big, torch.full_like(y, I32_MAX), y)


def fms(c: torch.Tensor, a, b: torch.Tensor) -> torch.Tensor:
    """float32 ``c - a * b`` rounded once, as XLA's fused multiply-add."""
    a64 = a.double() if isinstance(a, torch.Tensor) else float(
        torch.tensor(a, dtype=torch.float32))
    return (c.double() - a64 * b.double()).float()


def isum(x: torch.Tensor, dim) -> torch.Tensor:
    """int32 sum (torch promotes int32 sums to int64)."""
    return torch.sum(x.to(I32), dim=dim, dtype=I32)


def icumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cumsum(x.to(I32), dim=dim, dtype=I32)


def take(x: torch.Tensor, agent: torch.Tensor, row: torch.Tensor):
    """``x[agent, row]`` with ``row`` clamped to the table (lane gathers)."""
    return x[agent.long(), row.clamp(0, x.shape[1] - 1).long()]


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(A, R, ...) gathered at (A, n) clamped row indices -> (A, n, ...)."""
    a = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[a, idx.clamp(0, x.shape[1] - 1).long()]


def scatter_rows(x: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """Out-of-place ``x[a, idx[a, i]] = vals[a, i]`` for (A, n) ``idx``;
    rows outside [0, R) are dropped (JAX ``mode="drop"``)."""
    return scatter_rows_many([x], idx, [vals])[0]


def scatter_rows_many(xs, idx: torch.Tensor, vals) -> list:
    """:func:`scatter_rows` of several tables at the same (A, n) rows."""
    agent = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return scatter_many(xs, agent.expand_as(idx), idx, vals)


def scatter_lanes(x: torch.Tensor, agent: torch.Tensor, row: torch.Tensor,
                  vals, reduce: str | None = None) -> torch.Tensor:
    """Out-of-place ``x[agent, row] = vals`` over lanes of any shape, with
    out-of-range rows dropped through one spare row. ``reduce="amax"``
    scatters a max instead of a set."""
    return scatter_many([x], agent, row, [vals], reduce)[0]


def scatter_many(xs, agent: torch.Tensor, row: torch.Tensor, vals,
                 reduce: str | None = None) -> list:
    """:func:`scatter_lanes` of several (A, R, ...) tables at the same
    lanes, with the flat index computed once."""
    A, R = xs[0].shape[:2]
    ok = (row >= 0) & (row < R)
    flat_idx = torch.where(ok, agent.long() * R + row.long(),
                           A * R).reshape(-1)
    n = flat_idx.shape[0]
    out = []
    for x, v in zip(xs, vals):
        rest = x.shape[2:]
        flat = torch.cat([x.reshape((A * R,) + rest),
                          x.new_zeros((1,) + rest)])
        if not isinstance(v, torch.Tensor):
            v = torch.full((n,) + rest, v, dtype=x.dtype, device=x.device)
        v = v.to(x.dtype).reshape((n,) + rest)
        if reduce is None:
            flat = flat.index_put((flat_idx,), v)
        else:
            flat = flat.scatter_reduce(0, flat_idx, v, reduce,
                                       include_self=True)
        out.append(flat[:A * R].reshape(x.shape))
    return out


def group_sum(x: torch.Tensor, n_groups: int = 1) -> torch.Tensor:
    """The sum over the rows of each of ``n_groups`` equal runs of rows, in
    ``x``'s dtype, broadcast back to every row of the run."""
    g = x.reshape((n_groups, -1) + x.shape[1:])
    return g.sum(1, keepdim=True, dtype=x.dtype).expand_as(g).reshape(x.shape)
