"""The port's roofline arithmetic against the JAX package's, on the CPU with
no JAX compile: ``model_flops`` for every arch and applicable shape, the
``RooflineTerms`` properties on the same inputs (each term scaled by the
ratio of the two packages' constants), ``report.table`` and
``interesting_cells`` on the same synthetic records, the dot counter on
the reference's own scan and remat cases (``tests/test_dryrun_smoke.py``),
the weights' collectives of a placement, and the meta route of
``kernels.ops``."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.roofline import analysis as jroof  # noqa: E402
from repro.roofline import report as jreport  # noqa: E402
from repro_torch.configs.base import SHAPES, applicable_shapes  # noqa: E402
from repro_torch.configs.registry import ARCHS, get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import sharding as sh  # noqa: E402
from repro_torch.roofline import analysis as roof  # noqa: E402
from repro_torch.roofline import report  # noqa: E402
from repro_torch.roofline.count import DotCounter  # noqa: E402


def test_model_flops_is_the_references_for_every_cell():
    n = 0
    for arch in ARCHS:
        cfg = get_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jax_get_config(arch))
        for s in applicable_shapes(cfg):
            assert roof.model_flops(cfg, SHAPES[s]) == jroof.model_flops(
                jax_get_config(arch), JSHAPES[s]), (arch, s)
            n += 1
    assert n == 33


TERMS = [dict(arch="a", shape="train_4k", mesh="single", chips=256,
              flops_per_chip=3.1e15, bytes_per_chip=2.2e12,
              coll_bytes_per_chip=4.5e10,
              coll_by_kind={"all-gather": 4.5e10}, model_flops_total=5e17),
         dict(arch="b", shape="decode_32k", mesh="multi", chips=512,
              flops_per_chip=2.0e11, bytes_per_chip=9.0e10,
              coll_bytes_per_chip=7.0e9, coll_by_kind={}, model_flops_total=0.0),
         dict(arch="c", shape="prefill_32k", mesh="single", chips=256,
              flops_per_chip=0.0, bytes_per_chip=0.0, coll_bytes_per_chip=0.0,
              coll_by_kind={}, model_flops_total=1.0)]


@pytest.mark.parametrize("kw", TERMS, ids=lambda kw: kw["arch"])
def test_roofline_terms_are_the_references_scaled_by_the_constants(kw):
    t, j = roof.RooflineTerms(**kw), jroof.RooflineTerms(**kw)
    assert t.t_compute * tmesh.PEAK_FLOPS_BF16 == pytest.approx(
        j.t_compute * jmesh.PEAK_FLOPS_BF16, rel=1e-15)
    assert t.t_memory * tmesh.HBM_BW == pytest.approx(
        j.t_memory * jmesh.HBM_BW, rel=1e-15)
    assert t.t_collective * tmesh.LINK_BW == pytest.approx(
        j.t_collective * jmesh.ICI_BW_PER_LINK, rel=1e-15)
    assert t.useful_ratio == j.useful_ratio
    times = {"compute": t.t_compute, "memory": t.t_memory,
             "collective": t.t_collective}
    assert t.bottleneck == max(times, key=times.get)
    step = max(times.values())
    assert t.roofline_fraction == (
        (kw["model_flops_total"] / kw["chips"]) / tmesh.PEAK_FLOPS_BF16 / step
        if step else 0.0)
    assert list(t.row()) == list(j.row())
    assert roof.total_collective_bytes({"all-reduce": 3, "all-gather": 5}) \
        == jroof.total_collective_bytes({"all-reduce": 3, "all-gather": 5}) \
        == 11


def _records():
    rows = []
    for i, (arch, shape, mesh, gb) in enumerate((
            ("x", "train_4k", "single", 12.0), ("y", "decode_32k", "single",
                                                 3.0),
            ("z", "prefill_32k", "multi", 1.0), ("w", "long_500k", "single",
                                                 0.5))):
        t = roof.RooflineTerms(
            arch=arch, shape=shape, mesh=mesh, chips=256,
            flops_per_chip=1e14 * (i + 1), bytes_per_chip=1e11 / (i + 1),
            coll_bytes_per_chip=1e9 * (3 - i) if i < 3 else 5e12,
            coll_by_kind={}, model_flops_total=1e16 * (4 - i))
        rows.append({"arch": arch, "shape": shape, "mesh": mesh,
                     "status": "ok", "tag": "", "roofline": t.row(),
                     "memory_analysis": {"argument_size_in_bytes": gb * 1e9}})
    rows.append({"arch": "v", "shape": "train_4k", "mesh": "multi",
                 "status": "error", "tag": ""})
    return rows


def test_report_table_and_interesting_cells_are_the_references(tmp_path):
    rows = _records()
    for mesh in (None, "single", "multi"):
        assert report.table(rows, mesh) == jreport.table(rows, mesh)
    assert [r["arch"] for r in report.interesting_cells(rows)] == \
        [r["arch"] for r in jreport.interesting_cells(rows)] == ["y", "x"]
    # the one difference: a chip's memory, 80 GB on the H100, 16 on the v5e
    big = dict(rows[0], memory_analysis={"argument_size_in_bytes": 40e9})
    assert report.fits(big) == "40.0" and jreport.fits(big) == "40.0!"
    for r in rows:
        name = f"{r['arch']}__{r['shape']}__{r['mesh']}.json"
        (tmp_path / name).write_text(json.dumps(r))
    assert report.load(str(tmp_path)) == jreport.load(str(tmp_path))


def test_dot_counter_on_the_references_scan_and_remat_cases():
    # tests/test_dryrun_smoke.py::test_stablehlo_costs_scan_exact: eager
    # execution unrolls the scan, so each step's product is counted
    def f(x, w):
        for wi in w:
            x = torch.tanh(x @ wi)
        return x

    x = torch.empty((8, 256), device="meta")
    w = torch.empty((30, 256, 256), device="meta")
    base = 30 * 2 * 8 * 256 * 256
    with DotCounter() as c:
        f(x, w)
    assert c.costs() == {"flops": base,
                         "dot_bytes": 30 * 4 * (8 * 256 + 256 * 256
                                                + 8 * 256)}
    # ...grad_remat_multiplier: a checkpoint a step: forward, recomputed
    # forward, and two products a step backward (x wants a gradient too, so
    # the first step's is taken, as the reference's scan transposes every
    # step alike)
    xg = torch.zeros((8, 256), requires_grad=True)
    wg = torch.zeros((30, 256, 256), requires_grad=True)

    def g(x, w):
        for wi in w:
            x = torch.utils.checkpoint.checkpoint(
                lambda a, b: torch.tanh(a @ b), x, wi, use_reentrant=False)
        torch.autograd.grad(x.sum(), (xg, wg))

    with DotCounter() as c:
        g(xg, wg)
    assert c.flops == 4 * base
    assert set(c.by_op) == {"mm"}


def test_weight_collectives_of_a_placement():
    # one (d, f) = (4096, 1024) bf16 MLP leaf, fsdp on data, mlp on model
    leaves = {"layers.mlp.wi": ((2, 4096, 1024), torch.bfloat16,
                                ("layers", "fsdp", "mlp")),
              "final_norm": ((4096,), torch.float32, ("embed",))}
    single, multi = tmesh.make_production_mesh(), tmesh.make_production_mesh(
        True)
    shard = 2 * (4096 // 16) * (1024 // 16) * 2     # bytes on one device
    got = roof.weight_collectives(leaves, sh.DEFAULT_RULES, single, "train",
                                  batch_axes=("data",), remat=True)
    assert got["all-gather"] == 2 * shard * 16      # forward + recompute
    assert got["reduce-scatter"] == shard
    assert got["all-reduce"] == 4096 * 4            # the norm, over data
    got = roof.weight_collectives(leaves, sh.DEFAULT_RULES, multi, "train",
                                  batch_axes=("pod", "data"), remat=False)
    assert got["all-gather"] == shard * 16
    assert got["all-reduce"] == shard + 4096 * 4    # both, over pod
    got = roof.weight_collectives(leaves, sh.DEFAULT_RULES, single, "decode")
    assert got == {"all-gather": shard * 16, "all-reduce": 0.0,
                   "reduce-scatter": 0.0, "all-to-all": 0.0,
                   "collective-permute": 0.0}
    assert sh.shard_shape((2, 4096, 1024), (None, "data", "model"),
                          single) == (2, 256, 64)
    assert sh.shard_shape((256, 4096), (("pod", "data"), None),
                          multi) == (8, 4096)


class _OnCard:
    """A CUDA tensor's device and nothing else (no card needed)."""
    device = torch.device("cuda")
    is_cuda = True

    def contiguous(self):
        return self


def test_ops_meta_route_takes_the_plain_version_and_never_on_the_card(
        monkeypatch):
    q = torch.empty((8, 64, 16), device="meta")
    out = ops.flash_attention(q, q, q, causal=True)
    assert out.is_meta and out.shape == (8, 64, 16)
    assert not ops._on_card(q) and not ops._on_card(torch.empty(1))
    # a CUDA tensor takes the kernel, never the plain version
    calls = []
    monkeypatch.setattr(ops._fa, "flash_attention",
                        lambda *a, **k: calls.append("kernel"))
    monkeypatch.setattr(ops._ref, "attention",
                        lambda *a, **k: calls.append("plain"))
    card = _OnCard()
    ops.flash_attention(card, card, card, causal=True)
    ops.flash_attention(q, q, q, causal=True)
    assert calls == ["kernel", "plain"]
