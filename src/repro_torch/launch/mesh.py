"""The mesh of the drivers across devices (counterpart of
``repro.launch.mesh.make_sim_mesh``).

A mesh here is a list of torch devices, one a shard; ``Engine.
run_distributed`` packs ``ceil(A / D)`` agents on each of its D shards.
Shards may share a device, as the reference's forced host devices do: on
the CPU every shard is ``cpu``, and with fewer cards than shards several
shards share a card (which is not a multi-card run: their kernels queue on
one card).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device


def make_sim_mesh(n_devices: int | None = None, device=None) -> list:
    """``n_devices`` shards on ``device``'s kind (default: the CUDA card,
    which must exist). With no index given, shards spread over the cards
    there are in contiguous blocks (shard s on card ``s * cards // n``) and
    ``n_devices`` defaults to the card count; a CPU mesh defaults to one
    shard. An indexed device (``cuda:1``) holds every shard."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        cards = torch.cuda.device_count()
        n = cards if n_devices is None else int(n_devices)
        if n < 1:
            raise ValueError(f"a mesh needs at least one shard, got {n}")
        return [torch.device("cuda", s * cards // n) for s in range(n)]
    n = 1 if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    return [dev] * n
