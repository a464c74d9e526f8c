"""Device choice for the port's entry points: the card unless told otherwise."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; a missing card is an error, never a
    silent move to the CPU. Pass ``device="cpu"`` to run on the CPU."""
    if device is None or torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device unless told otherwise, and "
                "no CUDA device is available; pass device='cpu' to run on the "
                "CPU")
        return torch.device("cuda" if device is None else device)
    return torch.device(device)
