"""Render the roofline table and the dry-run summary from
results/dryrun/*.json, the counterpart of ``repro.roofline.report``.

    PYTHONPATH=src python -m repro_torch.roofline.report [--results DIR]

``fits`` reads the memory a chip holds: the port has no compiler, so its
records carry the arguments and outputs their placements give (parameters,
AdamW moments, the batch, the decode state, the logits; ``launch/dryrun.py``)
and no temporaries. The figure is a lower bound; ``!`` marks one above the
H100's 80 GB.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.mesh import HBM_PER_CHIP


def load(results_dir="results/dryrun", tag_filter=""):
    rows = []
    for p in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(p) as f:
            r = json.load(f)
        name = os.path.basename(p)[:-5]
        parts = name.split("__")
        r["tag"] = parts[3] if len(parts) > 3 else ""
        if r["tag"] != tag_filter:
            continue
        rows.append(r)
    return rows


def fits(r) -> str:
    m = r.get("memory_analysis", {})
    if not m:
        return "?"
    total = (m.get("argument_size_in_bytes", 0) + m.get("temp_size_in_bytes", 0)
             + m.get("output_size_in_bytes", 0)
             - m.get("alias_size_in_bytes", 0))
    return f"{total / 1e9:.1f}" + ("" if total <= HBM_PER_CHIP else "!")


def table(rows, mesh=None):
    out = ["| arch | shape | mesh | t_comp (s) | t_mem (s) | t_coll (s) | "
           "bottleneck | useful | roofline frac | mem GB/chip |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("status") != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"{r.get('status')} | | | | | | |")
            continue
        if mesh and r["mesh"] != mesh:
            continue
        t = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {t['t_compute_s']:.4f} | {t['t_memory_s']:.4f} "
            f"| {t['t_collective_s']:.4f} | {t['bottleneck']} "
            f"| {t['useful_ratio']:.2f} | {t['roofline_fraction']:.3f} "
            f"| {fits(r)} |")
    return "\n".join(out)


def interesting_cells(rows):
    """worst roofline fraction / most collective-bound / paper-representative."""
    ok = [r for r in rows if r.get("status") == "ok"
          and r["mesh"] == "single" and r["shape"] != "long_500k"]
    worst = min(ok, key=lambda r: r["roofline"]["roofline_fraction"])
    coll = max(ok, key=lambda r: (r["roofline"]["t_collective_s"]
                                  / max(max(r["roofline"]["t_compute_s"],
                                            r["roofline"]["t_memory_s"]),
                                        1e-12)))
    return worst, coll


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="results/dryrun")
    ap.add_argument("--mesh", default=None, choices=["single", "multi", None])
    args = ap.parse_args(argv)
    rows = load(args.results)
    print(table(rows, args.mesh))
    w, c = interesting_cells(rows)
    print(f"\nworst-fraction cell: {w['arch']} x {w['shape']} "
          f"(frac {w['roofline']['roofline_fraction']:.3f})")
    print(f"most collective-bound: {c['arch']} x {c['shape']} "
          f"(t_coll/t_major "
          f"{c['roofline']['t_collective_s'] / max(max(c['roofline']['t_compute_s'], c['roofline']['t_memory_s']), 1e-12):.2f})")


if __name__ == "__main__":
    main()
