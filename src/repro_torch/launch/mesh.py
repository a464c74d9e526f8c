"""Meshes and hardware constants, the counterpart of
``repro.launch.mesh``: the mesh of the drivers across devices
(``make_sim_mesh``), the production mesh the dry run places on
(``make_production_mesh``), and the H100's rates the roofline terms take.

A simulation mesh is a list of torch devices, one a shard; ``Engine.
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


def make_production_mesh(multi_pod: bool = False) -> dict:
    """The reference's production mesh as axis sizes (the dry run places
    on it and runs nothing there): 256 chips as (data 16, model 16), or
    two such pods with a leading ``pod`` axis. The shapes are the
    reference's, so a cell of either package reads the same placements."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


# Hardware constants of the roofline terms: one NVIDIA H100 SXM (80GB HBM3,
# 700 W), from NVIDIA's data sheet, dense rates. The collective term takes
# one link's rate, the reference's convention (its ICI_BW_PER_LINK): an
# NVLink 4 link moves 25 GB/s a direction, and an H100 has 18 of them
# (900 GB/s in all), so the term is the time over a single link, an upper
# bound on the time over all of them.
PEAK_FLOPS_BF16 = 989e12      # FLOP/s per chip, bf16 tensor cores
HBM_BW = 3.35e12              # bytes/s per chip
LINK_BW = 25e9                # bytes/s per NVLink 4 link, one direction
LINKS_PER_CHIP = 18
HBM_PER_CHIP = 80e9           # bytes
CHIPS_PER_POD = 256
