"""The dry run, the counterpart of ``repro.launch.dryrun``: every (arch x
shape x mesh) cell's step counted on the ``meta`` device, its roofline
terms on the H100's constants, one JSON record a cell.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.roofline.report

The reference forces 512 host devices, places the step on the production
mesh and reads XLA's lowering. Torch has no such partitioner, so the port
runs the real step at global shapes on meta tensors (no memory, no card,
no data) under ``roofline/count.py``'s counter:

* train: ``train/loop.py::make_train_step`` with AdamW, the parameters
  requiring gradients;
* prefill: ``Model.prefill_fn``;
* decode: ``Model.decode_fn`` on the meta decode state, one token at the
  prompt's last position.

The production mesh is a dict of axis sizes (``launch/mesh.py``), on which
``models/sharding.py`` places every parameter, input and state leaf: the
placements give the per-device memory (``memory_analysis``: arguments,
outputs and the donated part, no compiler temporaries) and the weights'
collectives (``roofline/analysis.py``; a record's ``"collectives":
"weights"`` says that activation collectives are not in it). Records go to
``results/dryrun/<arch>__<shape>__<mesh>[__tag].json`` in the reference's
format, so ``roofline/report.py`` and ``launch/simulate.py workload`` read
either package's. A failing cell is recorded with ``status: "error"`` and
the sweep goes on.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs.base import (SHAPES, ShapeConfig, TrainConfig,
                                      applicable_shapes)
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import sharding as sh
from repro_torch.models.layers import KVCache
from repro_torch.models.model import build_model
from repro_torch.roofline import analysis as roof
from repro_torch.roofline.count import DotCounter
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import init_opt_state

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun")

# Named sharding-rule variants, the reference's.
RULE_VARIANTS: dict[str, dict] = {
    "baseline": dict(sh.DEFAULT_RULES),
    # fsdp over both pod+data: ZeRO-3 across the fleet (more weight gather, less mem)
    "fsdp_global": {**sh.DEFAULT_RULES,
                    "fsdp": (("pod", "data"), ("data",))},
    # sequence-parallel activations off (saved acts replicated over model axis)
    "no_seqpar": {**sh.DEFAULT_RULES, "act_seq": ()},
    # experts preferred over mlp sharding disabled (TP inside experts)
    "moe_tp": {**sh.DEFAULT_RULES, "experts": ()},
    # decode: shard the residual stream's embed dim over model
    "decode_embed": {**sh.DEFAULT_RULES, "embed": (("model",),)},
    # inference: no ZeRO weight sharding (weights replicate over data)
    "serve": {**sh.DEFAULT_RULES, "fsdp": ()},
}

_KV_NAMES = ("layers", "batch", "seq_kv", "kv_heads", "head")


def _input_names(batch_specs: dict) -> dict:
    names = {}
    for k, v in batch_specs.items():
        if k == "positions3":
            names[k] = ("conv", "batch", "seq")
        elif v.dim() == 2:
            names[k] = ("batch", "seq")
        elif v.dim() == 3:
            names[k] = ("batch", "seq", "embed")
        else:
            names[k] = tuple(["seq"] * v.dim())
    return names


def decode_state_names(model, state: dict) -> dict:
    """A names tree congruent with the decode state's structure."""
    out = {}
    for key, sub in state.items():
        if key in ("kv", "kv_first") and sub is not None:
            out[key] = KVCache(k=_KV_NAMES, v=_KV_NAMES, length=("layers",))
        elif key == "cross":
            out[key] = (_KV_NAMES, _KV_NAMES)
        elif key == "rnn" and sub is not None:
            nm = {}
            for k2 in sub:
                if k2 == "S":
                    nm[k2] = ("layers", "batch", "heads", "head", "head")
                elif k2 == "ssd":
                    nm[k2] = ("layers", "batch", "heads", "ssm_state", "head")
                else:  # tm_prev / cm_prev
                    nm[k2] = ("layers", "batch", "seq", "embed")
            out[key] = nm
        else:
            out[key] = sub
    return out


def _pairs(tree, names):
    """(tensor, names) of every leaf of a state or batch tree."""
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield tree, names
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pairs(v, names[k])
    else:   # KVCache, (k, v)
        for v, n in zip(tree, names):
            yield from _pairs(v, n)


def placed_bytes(pairs, rules, mesh_shape: dict) -> int:
    """One device's bytes of (tensor or (shape, dtype), names) leaves."""
    total = 0
    for t, names in pairs:
        shape, dtype = (t.shape, t.dtype) if isinstance(t, torch.Tensor) \
            else t
        spec = (sh.spec_for(shape, names, rules, mesh_shape)
                if len(names) == len(shape) else (None,) * len(shape))
        total += math.prod(sh.shard_shape(shape, spec, mesh_shape)) \
            * dtype.itemsize
    return total


def _memory(model, shape: ShapeConfig, batch: dict, tc: TrainConfig,
            rules, mesh_shape: dict) -> dict:
    """Arguments, outputs and the donated part of one step, a device's
    share by the placements (the reference donates the parameters and
    moments in training, the decode state in decode)."""
    cfg = model.cfg
    leaves = model.leaves().values()
    params = placed_bytes([((s, d), n) for s, d, n in leaves], rules,
                          mesh_shape)
    inputs = placed_bytes(_pairs(batch, _input_names(batch)), rules,
                          mesh_shape)
    logits = placed_bytes(
        [(((shape.global_batch, cfg.vocab), torch.float32),
          ("batch", "vocab"))], rules, mesh_shape)
    if shape.mode == "train":
        opt_dt = getattr(torch, tc.opt_dtype)
        moments = 2 * placed_bytes([((s, opt_dt), n) for s, _, n in leaves],
                                   rules, mesh_shape) + 4
        return {"argument_size_in_bytes": params + moments + inputs,
                "output_size_in_bytes": params + moments,
                "alias_size_in_bytes": params + moments}
    state = model.decode_state_specs(shape)
    st = placed_bytes(_pairs(state, decode_state_names(model, state)),
                      rules, mesh_shape)
    if shape.mode == "prefill":
        return {"argument_size_in_bytes": params + inputs,
                "output_size_in_bytes": logits + st,
                "alias_size_in_bytes": 0}
    return {"argument_size_in_bytes": params + st + inputs,
            "output_size_in_bytes": logits + st,
            "alias_size_in_bytes": st}


def count_step(model, shape: ShapeConfig, tc: TrainConfig) -> DotCounter:
    """Run one step of ``shape``'s mode on the meta ``model`` under a
    :class:`DotCounter` and return it."""
    batch = model.input_specs(shape)
    with DotCounter() as c:
        if shape.mode == "train":
            step = make_train_step(model, tc)
            params = dict(model.named_parameters())
            step(params, init_opt_state(params, tc.opt_dtype), batch)
        elif shape.mode == "prefill":
            model.prefill_fn(batch)
        else:
            model.decode_fn(model.decode_state_specs(shape), batch["tokens"],
                            shape.seq_len - 1)
    return c


def run_cell(arch: str, shape_name, mesh_kind: str, *, rules_name="baseline",
             overrides=None, tag="", verbose=True, train_overrides=None,
             mesh: dict | None = None, counts: dict | None = None):
    """One cell's record. ``shape_name``: a key of ``SHAPES`` or a
    ``ShapeConfig``; ``mesh``: axis sizes in place of ``mesh_kind``'s
    production mesh (a one-chip mesh, ``{"data": 1, "model": 1}``, bounds a
    step timed on one card). The count does not depend on the mesh:
    ``counts``, a dict kept across calls, holds each (arch, shape)'s, so a
    sweep counts a step once for both meshes."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = (shape_name if isinstance(shape_name, ShapeConfig)
             else SHAPES[shape_name])
    if shape.name in SHAPES and shape.name not in applicable_shapes(cfg):
        return {"arch": arch, "shape": shape.name, "mesh": mesh_kind,
                "status": "skipped (DESIGN.md §6: not applicable)"}
    if cfg.causal_scheme != "rect":
        raise NotImplementedError(
            "the dry run counts the rectangular attention scheme only")
    mesh_shape = mesh or make_production_mesh(multi_pod=(mesh_kind == "multi"))
    rules = RULE_VARIANTS[rules_name]
    chips = math.prod(mesh_shape.values())
    tc = TrainConfig(**(train_overrides or {}))

    t0 = time.time()
    model = build_model(cfg, device="meta")
    key = (arch, shape, repr(overrides), repr(train_overrides))
    counts = {} if counts is None else counts
    if key not in counts:
        counter = count_step(model, shape, tc)
        counts[key] = (counter.costs(), counter.by_op)
    costs, by_op = counts[key]
    t_count = time.time() - t0

    batch_axes = sh.spec_axes(sh.spec_for((shape.global_batch,), ("batch",),
                                          rules, mesh_shape))
    coll = roof.weight_collectives(
        model.leaves(), rules, mesh_shape, shape.mode, batch_axes=batch_axes,
        remat=cfg.remat == "full", microbatches=tc.microbatches)
    terms = roof.terms_from_counts(arch, shape, mesh_kind, chips, cfg,
                                   costs, coll)
    mem = _memory(model, shape, model.input_specs(shape), tc, rules,
                  mesh_shape)
    result = {
        "arch": arch, "shape": shape.name, "mesh": mesh_kind, "chips": chips,
        "status": "ok", "rules": rules_name, "tag": tag,
        "overrides": {k: str(v) for k, v in (overrides or {}).items()},
        "count_s": round(t_count, 1),
        "count": costs,
        "count_by_op": by_op,
        "collectives": "weights",
        "memory_analysis": mem,
        "roofline": terms.row(),
    }
    if verbose:
        print(f"[dryrun] {arch} x {shape.name} x {mesh_kind}: "
              f"count {t_count:.1f}s  bottleneck={terms.bottleneck}  "
              f"t=({terms.t_compute:.4f},{terms.t_memory:.4f},"
              f"{terms.t_collective:.4f})s  frac={terms.roofline_fraction:.3f}")
        print("  memory_analysis:", mem)
    return result


def cell_path(arch, shape, mesh_kind, rules_name="baseline", tag="",
              results_dir=None):
    results_dir = results_dir or RESULTS_DIR
    os.makedirs(results_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else (
        f"__{rules_name}" if rules_name != "baseline" else "")
    return os.path.join(results_dir,
                        f"{arch}__{shape}__{mesh_kind}{suffix}.json")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCHS) + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--rules", default="baseline", choices=list(RULE_VARIANTS))
    ap.add_argument("--tag", default="")
    ap.add_argument("--set", action="append", default=[],
                    help="ModelConfig overrides, e.g. --set n_layers=8")
    ap.add_argument("--tset", action="append", default=[],
                    help="TrainConfig overrides, e.g. --tset microbatches=4")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--results", default=None,
                    help="record directory (default results/dryrun)")
    args = ap.parse_args(argv)

    def parse_kv(items):
        out = {}
        for kv in items:
            k, v = kv.split("=", 1)
            try:
                v = int(v)
            except ValueError:
                try:
                    v = float(v)
                except ValueError:
                    pass
            out[k] = v
        return out

    overrides = parse_kv(args.set)
    train_overrides = parse_kv(args.tset)

    cells = []
    if args.all:
        for a in ARCHS:
            for s in applicable_shapes(get_config(a)):
                for m in ("single", "multi"):
                    cells.append((a, s, m))
    else:
        assert args.arch and args.shape
        cells = [(args.arch, args.shape, args.mesh)]

    counts: dict = {}
    for a, s, m in cells:
        path = cell_path(a, s, m, args.rules, args.tag, args.results)
        if os.path.exists(path) and not args.force:
            print(f"[dryrun] cached: {path}")
            continue
        try:
            res = run_cell(a, s, m, rules_name=args.rules,
                           overrides=overrides or None, tag=args.tag,
                           train_overrides=train_overrides or None,
                           counts=counts)
        except Exception as e:  # noqa: BLE001 — record failures, keep sweeping
            res = {"arch": a, "shape": s, "mesh": m, "status": "error",
                   "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
            print(f"[dryrun] FAIL {a} x {s} x {m}: {e}")
        with open(path, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
