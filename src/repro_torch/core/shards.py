"""The shard layout of the drivers across devices and its collectives (the
counterpart of ``repro.core.engine.ShardAxes`` and of the ``pmin``, ``psum``
and staged ``all_to_all`` that the reference runs under ``shard_map``).

A mesh is a list of torch devices, one a shard. Shards may share a device:
D entries of ``cpu``, or of ``cuda:0`` on one card, are D shards as the
reference's forced host devices are. The stacked state is padded to ``size
= D * K`` rows and laid out shard-major: shard s holds agents ``s*K`` to
``s*K + K - 1`` on ``devices[s]``. One controller runs every shard's window
program in lockstep (:func:`lockstep`). A program is a generator that
yields at each point where it needs the other shards, and the driver
resolves the D requests together and sends each shard its part:

* :class:`Min` - the GVT: the min of every row's (K, C) local minima,
  broadcast to every row (``pmin``);
* :class:`Exchange` - the routing ``all_to_all``: row a's (size * rcap, ...)
  send buffer holds its block for agent d at columns ``d*rcap``, and agent d
  receives every row's block d in ascending source order. Shard blocks move
  first (shard s to shard t), then lane blocks inside the shard (a
  transpose), so the receive order is the one-device exchange's;
* :class:`Sum` - the owner-wins sync: a sum over all rows, exact because
  each element has one nonzero contribution (``psum``);
* :class:`Read` - a host read, one for all shards.

``n_groups`` stacks replicas on the rows of one shard (``Engine.
run_ensemble``): each reduction and the exchange then act within each
replica's ``size`` rows. One shard of one group is the one-device driver,
whose collectives are the reductions over the leading dimension.
"""
from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import sync
from repro_torch.core import tensor_util as tu


class Min(NamedTuple):
    x: torch.Tensor          # (K, C) a shard's per-row local minima


class Sum(NamedTuple):
    parts: list              # (K, ...) tensors, one nonzero term an element


class Exchange(NamedTuple):
    cols: list               # (K, size * rcap, ...) send buffers
    rcap: int


class Read(NamedTuple):
    x: torch.Tensor          # read to the host (one dtype over the shards)


class ShardAxes(NamedTuple):
    """``devices[s]`` holds shard s's ``n_lanes`` (K) rows; ``size`` is the
    fleet's (padded) agent count, the global id of shard s's row k being
    ``s*K + k`` (within its replica)."""

    devices: tuple
    n_lanes: int
    n_groups: int = 1

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        return self.n_shards * self.n_lanes // self.n_groups

    def me(self, s: int) -> torch.Tensor:
        """(K,) int32 global agent ids of shard ``s``'s rows."""
        return _me(self, s)

    def on(self, s: int):
        """Shard ``s``'s CUDA device as the current one (its kernels launch
        on that card's stream), when the shards span several devices."""
        dev = self.devices[s]
        if dev.type == "cuda" and len(set(self.devices)) > 1:
            return torch.cuda.device(dev)
        return contextlib.nullcontext()

    # ------------------------------------------------------------ collectives
    def global_min(self, xs: list) -> list:
        if self.n_shards == 1:
            return [sync.global_min(xs[0], self.n_groups)]
        d0 = self.devices[0]
        g = torch.cat([x.amin(0, keepdim=True).to(d0) for x in xs]).amin(
            0, keepdim=True)
        return [g.to(d).expand_as(x) for d, x in zip(self.devices, xs)]

    def owner_sum(self, parts: list) -> list:
        if self.n_shards == 1:
            return [[tu.group_sum(x, self.n_groups) for x in parts[0]]]
        d0 = self.devices[0]
        tot = [torch.stack([p[i].sum(0, dtype=p[i].dtype).to(d0)
                            for p in parts]).sum(0, dtype=p0.dtype)
               for i, p0 in enumerate(parts[0])]
        return [[t.to(d).expand_as(x) for t, x in zip(tot, p)]
                for d, p in zip(self.devices, parts)]

    def exchange(self, cols: list, rcap: int) -> list:
        n, k = self.size, self.n_lanes
        if self.n_shards == 1:
            g = self.n_groups
            return [[b.reshape((g, n, n, rcap) + b.shape[2:]).transpose(
                1, 2).reshape(b.shape) for b in cols[0]]]
        out = []
        for t, dev in enumerate(self.devices):
            lo, hi = t * k * rcap, (t + 1) * k * rcap
            got = []
            for c in range(len(cols[0])):
                x = torch.cat([sc[c][:, lo:hi].to(dev) for sc in cols])
                got.append(x.reshape((n, k, rcap) + x.shape[2:]).transpose(
                    0, 1).reshape((k, n * rcap) + x.shape[2:]))
            out.append(got)
        return out

    def read(self, xs: list, read) -> list:
        """``read(tensor) -> numpy`` once for every shard's tensor."""
        if self.n_shards == 1:
            return [read(xs[0])]
        d0 = self.devices[0]
        host = read(torch.cat([x.reshape(-1).to(d0) for x in xs]))
        cut = np.cumsum([x.numel() for x in xs])[:-1]
        return [h.reshape(x.shape) for h, x in zip(np.split(host, cut), xs)]


@functools.lru_cache(maxsize=256)
def _me(axes: ShardAxes, s: int) -> torch.Tensor:
    k = axes.n_lanes
    return (tu.arange(k, axes.devices[s]) + s * k) % axes.size


_RESOLVE = {
    Min: ("window.gvt", lambda ax, rs, read: ax.global_min(
        [r.x for r in rs])),
    Sum: ("window.owner_sum", lambda ax, rs, read: ax.owner_sum(
        [r.parts for r in rs])),
    Exchange: ("window.exchange", lambda ax, rs, read: ax.exchange(
        [r.cols for r in rs], rs[0].rcap)),
    Read: ("window.read", lambda ax, rs, read: ax.read([r.x for r in rs],
                                                       read)),
}


def lockstep(axes: ShardAxes, progs: list, read) -> list:
    """Run one program a shard to its end, resolving each round of requests
    over all shards (under its own ``record_function`` label), and return
    the programs' results. Every shard must make the same requests in the
    same order; ``read`` is the engine's counted host read."""
    sends = [None] * len(progs)
    while True:
        reqs, outs = [], []
        for s, prog in enumerate(progs):
            with axes.on(s):
                try:
                    reqs.append(prog.send(sends[s]))
                except StopIteration as stop:
                    outs.append(stop.value)
        if outs:
            if reqs:
                raise RuntimeError("shards left the window out of step")
            return outs
        op = type(reqs[0])
        if any(type(r) is not op for r in reqs):
            raise RuntimeError(f"shards out of step: "
                               f"{sorted({type(r).__name__ for r in reqs})}")
        label, resolve = _RESOLVE[op]
        with record_function(label):
            sends = resolve(axes, reqs, read)
