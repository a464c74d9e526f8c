"""The dry run's count against the JAX package's, on the CPU: for one smoke
config of each family, the reference's step lowered to StableHLO with no
mesh (no compile) and read by ``repro.roofline.hlocount.stablehlo_costs``,
the port's step run on ``meta`` under ``roofline/count.py``.

* prefill and decode: dot FLOPs and dot bytes equal, integer for integer;
* training (AdamW, ``remat="full"`` as every config, and one family with
  ``"none"``): the port's count is the reference's plus the work that only
  the port does, each item computed from the shapes (:func:`extra_work`),
  FLOPs and bytes exactly;
* one ``run_cell`` record read back by both packages' ``cell_from_roofline``
  and ``report.table``.

Two tests, so the file queues after the larger ones (ROADMAP.md, test
budget)."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.configs.registry import smoke_config as jax_smoke_config  # noqa: E402
from repro.core.workload import cell_from_roofline as jax_cell  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.roofline import report as jreport  # noqa: E402
from repro.roofline.hlocount import stablehlo_costs  # noqa: E402
from repro.train.loop import make_train_step as jax_train_step  # noqa: E402
from repro.train.optimizer import init_opt_state as jax_opt  # noqa: E402
from repro_torch.configs.base import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.configs.registry import smoke_config  # noqa: E402
from repro_torch.core.workload import cell_from_roofline  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.roofline import report  # noqa: E402

FAMILIES = ("smollm-135m", "moonshot-v1-16b-a3b", "hymba-1.5b", "rwkv6-7b",
            "qwen2-vl-72b", "whisper-large-v3")
B = 2


def _seq(arch: str) -> int:
    return 1024 if arch == "qwen2-vl-72b" else 256   # qwen2-vl: 1024 patches


def reference_costs(arch: str, mode: str, **over) -> dict:
    """stablehlo_costs of the reference's step at (B, seq), no mesh."""
    jm = jax_build_model(dataclasses.replace(jax_smoke_config(arch), **over))
    params = jax.eval_shape(lambda r: jm.init(r)[0], jax.random.PRNGKey(0))
    shape = JShape("t", _seq(arch), B, mode)
    batch = jm.input_specs(shape)
    if mode == "train":
        lowered = jax.jit(jax_train_step(jm, JTrain())).lower(
            params, jax.eval_shape(jax_opt, params), batch)
    elif mode == "prefill":
        lowered = jax.jit(jm.prefill_fn).lower(params, batch)
    else:
        lowered = jax.jit(jm.decode_fn).lower(
            params, jm.decode_state_specs(shape), batch["tokens"],
            jax.ShapeDtypeStruct((), jnp.int32))
    return {k: int(v) for k, v in stablehlo_costs(lowered.as_text()).items()}


def port_costs(arch: str, mode: str, **over) -> dict:
    cfg = dataclasses.replace(smoke_config(arch), **over)
    model = build_model(cfg, device="meta")
    return dryrun.count_step(model, ShapeConfig("t", _seq(arch), B, mode),
                             TrainConfig()).costs()


def _divisor(n: int, c: int) -> int:
    c = min(c, n)
    while n % c:
        c -= 1
    return c


def _attention(cfg, sq: int, skv: int) -> tuple[int, int]:
    """(FLOPs, bytes) of the reference's chunked attention forward, float32:
    per key chunk, q k^T and p v."""
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    ck = _divisor(skv, cfg.attn_chunk_kv)
    q, kc, s = B * sq * h * hd, B * ck * kv * hd, B * sq * h * ck
    return 4 * B * h * sq * skv * hd, 4 * (skv // ck) * 2 * (q + kc + s)


def _scan(cfg, s: int, mode: str) -> tuple[int, int, int, int]:
    """(FLOPs, bytes) of the reference's chunked scan forward in float32
    (``linear_rnn.gla_chunked``), and of the three products a scan's
    backward in the port does not take (the zero start state's gradient,
    the unused final state's two)."""
    h, dv = cfg.n_heads, cfg.head_dim
    dk = dv if mode == "k" else cfg.ssm_state
    c = _divisor(s, cfg.chunk_gla)
    qk, v, st, sq = B * c * h * dk, B * c * h * dv, B * h * dk * dv, \
        B * h * c * c
    prods = [(2 * B * h * c * c * dk, qk + qk + sq),       # q k^T
             (2 * B * h * c * dk * dv, qk + st + v),       # q S
             (2 * B * h * c * c * dv, sq + v + v),         # (q k^T) v
             (2 * B * h * c * dk * dv, qk + v + st)]       # k^T v: state
    if mode == "k":   # the bonus: einsum("bihk,hk,bihk->bhi"), two products
        prods += [(2 * qk, qk + h * dk + qk), (2 * qk, 2 * qk + B * h * c)]
    n = s // c
    skip = 3 * 2 * B * h * c * dk * dv, 3 * 4 * (qk + v + st)
    return (n * sum(f for f, _ in prods), 4 * n * sum(b for _, b in prods),
            *skip)


def extra_work(arch: str, remat: str = "full") -> tuple[int, int]:
    """(FLOPs, bytes) the port's training step does beyond the reference's.

    * ``layers.FlashAttention`` and ``linear_rnn.GlaScan`` recompute their
      forward in the backward: one attention (float32) and one scan (in
      float64: every operand twice the bytes, the gradients' too) a call.
    * With ``remat="full"`` the block's recompute runs them forward again
      (the reference's remat keeps its inner scans' residuals).
    * The port's scan backward skips three products a call (``_scan``).
    """
    cfg = smoke_config(arch)
    s = _seq(arch)
    passes = 2 if remat == "full" else 1
    if cfg.family == "encdec":
        d = cfg.decoder_len
        attn = ([(s, s)] * cfg.encoder_layers
                + [(d, d), (d, s)] * cfg.n_layers)
    elif cfg.family == "ssm":
        attn = []
    else:
        attn = [(s, s)] * cfg.n_layers
    flops = nbytes = 0
    for sq, skv in attn:
        f, b = _attention(cfg, sq, skv)
        flops, nbytes = flops + passes * f, nbytes + passes * b
    if cfg.family in ("ssm", "hybrid"):
        f, b, skip_f, skip_b = _scan(cfg, s, "k" if cfg.family == "ssm"
                                     else "v")
        # forward f32 (remat), recompute f64 (2x bytes), gradients f64 less
        # the skipped: against the reference's gradients in float32
        flops += cfg.n_layers * (passes * f - skip_f)
        nbytes += cfg.n_layers * ((passes + 3) * b - 2 * skip_b)
    return flops, nbytes


def test_the_count_is_the_references_for_every_family():
    for arch in FAMILIES:
        for mode in ("prefill", "decode"):
            assert port_costs(arch, mode) == reference_costs(arch, mode), \
                (arch, mode)
        want = reference_costs(arch, "train")
        got = port_costs(arch, "train")
        flops, nbytes = extra_work(arch)
        assert got == {"flops": want["flops"] + flops,
                       "dot_bytes": want["dot_bytes"] + nbytes}, arch
    got = port_costs("hymba-1.5b", "train", remat="none")
    want = reference_costs("hymba-1.5b", "train", remat="none")
    flops, nbytes = extra_work("hymba-1.5b", "none")
    assert got == {"flops": want["flops"] + flops,
                   "dot_bytes": want["dot_bytes"] + nbytes}


def test_a_run_cell_record_reads_back(tmp_path):
    shape = ShapeConfig("train_4k", 256, 16, "train")
    over = dict(n_layers=2, d_model=256, n_heads=4, n_kv=2, d_ff=512,
                vocab=1024, head_dim=64)
    rec = dryrun.run_cell("smollm-135m", shape, "multi", overrides=over,
                          verbose=False)
    assert rec["status"] == "ok" and rec["chips"] == 512
    assert rec["collectives"] == "weights"
    kinds = rec["roofline"]["coll_by_kind"]
    assert kinds["all-reduce"] > 0 and kinds["all-gather"] > 0
    assert rec["count"]["flops"] > 0
    cell, jcell = (cell_from_roofline(rec["roofline"], n_pods=2, n_steps=4),
                   jax_cell(rec["roofline"], n_pods=2, n_steps=4))
    assert dataclasses.asdict(cell) == dataclasses.asdict(jcell)
    assert cell.dcn_bytes_per_pod == kinds["all-reduce"]
    path = dryrun.cell_path("smollm-135m", "train_4k", "multi",
                            results_dir=str(tmp_path))
    with open(path, "w") as f:
        json.dump(rec, f)
    rows = report.load(str(tmp_path))
    assert report.table(rows) == jreport.table(rows)
    assert len(report.table(rows).splitlines()) == 3
