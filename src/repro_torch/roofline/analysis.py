"""Roofline terms of a dry-run cell, the counterpart of
``repro.roofline.analysis``, on the H100's constants
(``launch/mesh.py``).

Three terms per (arch x shape x mesh) cell, all in seconds:
  compute    = dot FLOPs per chip / peak bf16 FLOP/s
  memory     = (dot bytes + resident parameter bytes) per chip / HBM rate
  collective = collective bytes per chip / one link's rate

FLOPs and dot bytes are the global program's (``roofline/count.py`` on the
meta device) over the chip count, plus one read of the parameters a step,
exactly as the reference's ``terms_from_artifacts`` takes them from its
StableHLO. ``model_flops`` (6 N D for training, 2 N D forward) over the
count gives ``useful_ratio``, which shows recomputed and redundant work.

Collectives. The reference parses the partitioned HLO (``collective_bytes``,
``hlocount.collective_costs``); the port has no SPMD partitioner and no
HLO, so those have no counterpart. :func:`weight_collectives` takes what the
parameters' placements alone determine (``models/sharding.py``): for each
leaf whose ``fsdp`` dim is sharded, an all-gather over those axes a forward
pass (and a remat recompute of a layer's block in training), and in
training a reduce-scatter of its gradient over the same axes; and an
all-reduce of the gradient shard over the batch axes the leaf is
replicated on (``pod`` on the two-pod mesh). Each is counted as its
per-device result bytes, and an all-reduce twice (ring reduce-scatter plus
all-gather), the reference's conventions. Activation collectives (the
tensor-parallel all-reduces, ``act_seq`` gathers, the MoE all-to-all) are
NOT counted: only a partitioner decides them. A record says so with
``"collectives": "weights"``.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16
from repro_torch.models import sharding as sh

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def total_collective_bytes(per_kind: dict[str, int]) -> int:
    tot = 0
    for k, v in per_kind.items():
        tot += 2 * v if k == "all-reduce" else v
    return tot


def weight_collectives(leaves: dict, rules, mesh_shape: dict, mode: str, *,
                       batch_axes: tuple = (), remat: bool = False,
                       microbatches: int = 1) -> dict[str, float]:
    """Per-device result bytes by collective kind of one step's parameter
    traffic. ``leaves``: {path: (shape, dtype, names)} (``Model.leaves``);
    ``batch_axes``: the mesh axes the step's batch is split over. A leaf
    under ``layers``/``first_layers``/``encoder`` is in a remat block."""
    out = {k: 0.0 for k in _COLLECTIVES}
    passes = microbatches if mode == "train" else 1
    for path, (shape, dtype, names) in leaves.items():
        spec = sh.spec_for(shape, names, rules, mesh_shape)
        itemsize = dtype.itemsize
        shard = math.prod(sh.shard_shape(shape, spec, mesh_shape)) * itemsize
        fsdp = [a for n, p in zip(names, spec) if n == "fsdp"
                for a in sh.spec_axes((p,))]
        if fsdp:
            gathers = passes
            if mode == "train" and remat and path.split(".")[0] in (
                    "layers", "first_layers", "encoder"):
                gathers *= 2
            out["all-gather"] += gathers * shard * math.prod(
                mesh_shape[a] for a in fsdp)
            if mode == "train":
                out["reduce-scatter"] += shard
        if mode == "train":
            used = set(sh.spec_axes(spec))
            if any(a not in used for a in batch_axes):
                out["all-reduce"] += shard
    return out


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_by_kind: dict
    model_flops_total: float

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_chip / LINK_BW

    @property
    def bottleneck(self) -> str:
        t = {"compute": self.t_compute, "memory": self.t_memory,
             "collective": self.t_collective}
        return max(t, key=t.get)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs (remat & redundancy waste detector)."""
        total = self.flops_per_chip * self.chips
        return self.model_flops_total / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / achievable step time (max of the three terms)."""
        t_useful = (self.model_flops_total / self.chips) / PEAK_FLOPS_BF16
        t_step = max(self.t_compute, self.t_memory, self.t_collective)
        return t_useful / t_step if t_step else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops_total,
            "hlo_flops_per_chip": self.flops_per_chip,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "coll_by_kind": self.coll_by_kind,
        }


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6*N*D (dense) or 6*N_active*D (MoE); D = tokens processed per step.

    Train counts fwd+bwd (6); prefill counts fwd only (2); decode counts fwd for
    global_batch single tokens. Enc-dec splits N across the two stacks since
    they see different token counts (encoder: seq_len frames; decoder: the
    448-token transcript).
    """
    n = cfg.active_param_count if cfg.n_experts else cfg.param_count
    mult = {"train": 6.0, "prefill": 2.0, "decode": 2.0}[shape.mode]
    if cfg.encoder_layers:
        frac_enc = cfg.encoder_layers / (cfg.encoder_layers + cfg.n_layers)
        n_enc, n_dec = n * frac_enc, n * (1 - frac_enc)
        if shape.mode == "decode":
            return 2.0 * n_dec * shape.global_batch
        d_enc = shape.global_batch * shape.seq_len
        d_dec = shape.global_batch * cfg.decoder_len
        return mult * (n_enc * d_enc + n_dec * d_dec)
    if shape.mode == "decode":
        return 2.0 * n * shape.global_batch
    return mult * n * shape.global_batch * shape.seq_len


def terms_from_counts(arch: str, shape_cfg: ShapeConfig, mesh_name: str,
                      chips: int, cfg: ModelConfig, costs: dict,
                      coll_by_kind: dict) -> RooflineTerms:
    """The counterpart of the reference's ``terms_from_artifacts``: compute
    and memory from the global program's count (``costs``: ``flops``,
    ``dot_bytes``) over the chips, memory adding one read of the resident
    parameters a step (bf16, ``cfg.param_count`` x 2 bytes); collectives
    from ``coll_by_kind`` (per-device bytes, :func:`weight_collectives`)."""
    param_bytes = cfg.param_count * 2.0  # bf16 residents
    return RooflineTerms(
        arch=arch, shape=shape_cfg.name, mesh=mesh_name, chips=chips,
        flops_per_chip=costs["flops"] / chips,
        bytes_per_chip=costs["dot_bytes"] / chips + param_bytes / chips,
        coll_bytes_per_chip=float(total_collective_bytes(coll_by_kind)),
        coll_by_kind={k: float(v) for k, v in coll_by_kind.items()},
        model_flops_total=model_flops(cfg, shape_cfg),
    )
