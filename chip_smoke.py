#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port: the quickest proof that it runs.

    python3 chip_smoke.py

Needs one CUDA card (fails without one, and fails when run outside a
checkout of the repository). The CPU reference runs and the sequential
oracles that phases 4-4h compare against run in four worker processes
started first (``Background``), beside the card's phases, which take their
results when they need them. Phases, each of which raises on failure:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compile each ``src/repro_torch/kernels/csrc/*.cu`` for sm_90a,
   one nvcc per source, all started together; ptxas' registers and spills
   of each kernel (group_by_kind's, ring_slots' and route_rank's on lines
   of their own),
   the GLA tensor-core kernels' shared memory and CTAs per
   SM, and the max-min warp kernel's CTAs per SM;
3. kernels: each of the six window front-end kernels against its plain
   PyTorch version on the card, byte for byte, at the main paths' shapes
   (8 agents; select over pool_cap 4096 -> 256, also 1000 and 16384, on
   the adversarial pools of tests/test_torch_select.py and m from 1 to
   cap; group over 256 rows with 8 kinds; trace over 256, int32, bool and
   uint8 masks; route over 4096 rows with 9 buckets; fused_select over
   pool_cap 4096 -> 256, also 1000 and 16384, on the same adversarial pools
   and m = 1, 512, 513 (both sides of the radix/bitonic boundary) and cap;
   ring_slots over a 4096 ring and 4096 rows) and on edge cases (group at
   m from 1 to 4096, 1, 8 and 32 kinds, bool, uint8 and int32 masks; ring
   at n from 1 to 12289, masks 0-3 bytes off a word, heads near 2^31 - 1
   over a 4096 and a 3001 ring; route at n from 1 to 12289 with 1 to 64
   buckets, uniform, all sentinel, one key and the engine's compaction,
   directly and through ``ops``, keys outside the contract, and the
   launcher's refusals); the
   max-min water-fill bit for bit, each call's kernel checked against the
   dispatch rule (a warp per lane up to 32 flows and 32 links, else a
   block), at tiered_grid's shapes (2048, 8 and 1 lanes of 32 flows over 4
   links), both sides of the rule (32 or 33 flows or links, one flow, one
   link), one lane at every tabled flow-sum order, the 64-pod workload's
   (256 and 1 lanes of 128 flows over 64 links) and edge cases; then each
   timed with CUDA events (the Python
   call) and under torch.profiler (the kernel's own device time) against
   the plain version, the bound and, where one exists, a single PyTorch
   call (group_by_kind's row is the engine's call, ``ops`` on the bool
   mask); then trace_rank as the engine calls it (a bool mask through
   ``ops``) and where its call's host time goes, piece by piece, the same
   for group_by_kind, ring_slots and route_rank (each against its former
   call path in turns; route_rank also timed on a ``dst_agent`` captured
   from stitched ``tiered_grid`` through the engine's ``route_fn`` hook,
   against a stable ``argsort``, and its kernel with 4 steps kept in
   registers against a build that walks twice, in turns) and for
   maxmin_rates at (2048, 32, 4);
3z. the model zoo's kernels against their plain versions on the card, in
   float32 (attention's FFMA kernel) and bfloat16 (its wgmma kernel), at
   the serve path's shapes: flash attention at hymba-1.5b's prefill (4 x 25
   query heads, 4 x 5 KV heads of 64, S 2048, window 1024; also window 0),
   at S 1000 (windows 1024 and 100), non-causal, D 128 with a window,
   at the smoke configs' head dim 16, and causal with Sq != Skv (fewer
   queries than keys and more, with and without a window; the largest
   error of those against 2e-6 and 2e-2); ``rwkv6_scan`` at rwkv6-7b's
   (4 x 64 heads of 64, S 2048, chunk 64; bfloat16 through the TF32
   tensor-core kernel, float32 through the FFMA one) and ``ssd_scan`` at
   hymba's SSD (4 x 25 heads, state 16, head 64; bfloat16 through its
   tensor-core kernel over 16-column slices), both also at S 1000 (the
   divisor rule's chunk 50), ``ssd_scan`` also at state 64 and at state 24
   with head 40, and refusing a q that is not 16-byte aligned; flash
   attention also at the shapes of the moe, vlm and encdec families
   (whisper's encoder: non-causal, 4 x 20 heads of 64, 1,500 frames; its
   cross-attention: 4 queries over the 1,500 frames; moonshot's prefill:
   4 x 16 heads of 128, S 2048, causal); then each
   timed (CUDA events and device time) against the
   plain version, the bound and, for attention,
   ``scaled_dot_product_attention`` with the same mask, with the achieved
   TFLOP/s and share of the bound (attention at hymba's shape and at the
   three family shapes);
4. the stitched main path at real size: the ``tiered_grid`` scenario
   (WLCG's tier shape: one Tier-0, 13 Tier-1, 4 Tier-2 per Tier-1; 8
   agents, pool_cap 4096) through ``Engine.run_local`` on the card, with
   every launch count set to 0 before and read after (the flow handlers
   launch ``maxmin_rates``, every call through its warp kernel); no drops;
   byte-equal to the same run on the CPU; its merged trace equal to the
   sequential oracle;
4b. the fused front end (``fused_select=True``) on the same scenario at the
   same size: byte-equal to the stitched card run of phase 4, its merged
   trace equal to the oracle, no drops, ``fused_select`` and ``ring_slots``
   launched and ``select_events`` and ``group_by_kind`` not;
   then both paths profiled over 20 windows;
4c. the workload bridge at full width: ``simulate_training`` of a 64-pod
   cell (128 flow slots over 64 WAN links, one agent; the depth cut to one
   training step) on the card, ``maxmin_rates`` launched (its block
   kernel), equal to the CPU run; then ``simulate workload`` on a record
   written to a temporary directory, ``--device cuda`` equal to
   ``--device cpu``;
5. the normal entry point, ``repro_torch.launch.simulate t0t1`` on the card
   at two of its four bandwidths (8.0 and 2.0 MB a tick) with 1 and 4
   agents, and with 4 agents under ``--fused-select``, under
   ``--insert-mode ref --merge-mode dense`` and under ``--adaptive-exec``,
   each equal to ``--device cpu`` (run in the worker processes) and to the
   stitched run;
4e. the two models defined outside core, through ``Engine.run_local`` on
   both front ends (8 agents, the registries' 10 and 11 kinds): the
   replica cache (1,024 caches of 8 ways, 8 keys, 10 rounds) and the
   failure/repair process (64 farms of 16 CPUs, 2 processes a farm, bursts
   of 3, a job generator a farm; also ``run_adaptive``), each run's launch
   counts, events/s and windows, a profile of 10 windows (device ops a
   window), no drops, byte-equal to the CPU run and in full-row order to
   the oracle; then ``failures.xla_log`` on all 2^22 unit draws, card
   against CPU, and int32 payload bit patterns (31-bit, denormal, NaN)
   through both front ends;
4g. the ensemble driver on phase 4e's failure model: 256 replicas (seeds
   0-255, 2,048 rows) through ``Engine.run_ensemble`` on the card with a
   4,096-row trace per replica and agent, the launch counts set to 0
   before and read after (each stitched hook once a window, every launch
   at 2,048 rows), its bytes reckoned before the run; every replica done,
   nothing dropped; replica 0 equal to phase 4e's stitched card run (the
   trace by its written rows), replica 255 equal to the card
   ``run_local`` of its seeded state, and its merged trace equal
   to the oracle of its seeded world in full-row order, the windows
   spread; the fused ensemble of 32 replicas equal to the first 32; a
   4-replica ensemble of a 16-farm, 4-agent cut equal on the card and the
   CPU; events/s, ms, host reads and fallback steps a window beside phase
   4e's run, a profile of 10 windows, peak memory; then ``simulate
   ensemble`` (card and CPU lines equal), ``simulate run --list``, ``run
   ensemble_farm`` (card and CPU), ``run t0t1`` preempted at window 12 and
   resumed with ``--stream-check``, and ``run t0t1`` killed by SIGKILL
   after a checkpoint and resumed by the same command;
4f. the host layer on phase 4's stitched ``tiered_grid``: the run streamed
   through a 512-row trace ring (drained every 16 windows), metrics every
   32 windows and a checkpoint every 64, equal to phase 4's card state and
   merged trace with C_TRACE_DROP 0; a resume from the checkpoint of
   window 320 (past the ring) into a fresh engine, equal to the streamed
   run (state, trace, metrics records); a placement at window 320 (the
   same checkpoint, restored into a fresh streamed engine) from the
   counters' performance values (``route_rank`` over the whole pool), its
   streamed continuation equal to the oracle; then ``simulate t0t1`` with
   a 32-row ring killed by SIGKILL after the checkpoint at window 40, and
   resumed on the card and on the CPU to the uninterrupted line. It prints
   ms a window and events/s streamed and not, host reads a window, ring
   copies, ms and bytes a checkpoint, ms a restore and ms a migration;
4h. the drivers across devices: a mesh of 4 shards on the card(s) (with
   one card, all on it: the shards' collectives and kernels at K rows, not
   multi-card scaling), phase 4's ``tiered_grid`` (8 agents, K = 2) through
   ``Engine.run_distributed`` stitched at full depth, byte-equal to phase
   4's card ``run_local`` and its sorted merged trace to the oracle, each
   hook of the path launched 4 times a window at 2 rows; then at 48
   windows against ``run_local`` stepped as far: the fused front end on 4
   shards (against the fused ``run_local``, the trace too), 3 shards (K =
   3, one pad agent), 8 shards (K = 1), ``run_distributed_adaptive``
   over (16, 64, 256) with ``run_adaptive``'s rungs,
   ``apply_placement_distributed`` against ``apply_placement_local``, and a
   streamed run checkpointed every 16 windows, stopped at window 32 and
   resumed on 2 shards; the 64-flow grid at 2 agents on 2 shards (K = 1)
   against the CPU port's run (and unlike ``run_local``: the one-lane flow
   order); the exchange's host and device ms on a window's send buffers
   and a 10-window profile of the sharded window (from window 48); then
   ``simulate distributed --devices 4`` (card against CPU) and ``simulate
   run t0t1 --devices 2`` preempted to one survivor (``reshard=1``). It
   prints ms a window, events/s and host reads a window at each D beside
   ``run_local``'s, and the launches of each kernel;
4z. the model path at full width and cut depth in float32 with TF32 off,
   one set of seeded weights (drawn on the CPU in chunks,
   ``seeded_weights``) on the card (the kernels) and, in the worker
   processes, on the CPU (the plain versions): hymba-1.5b and rwkv6-7b
   with 2 layers (B 2, S 2048 and 1024), moonshot-v1-16b-a3b with its
   dense first layer and one MoE layer (B 2, S 1024), whisper-large-v3
   with 2 encoder and 2 decoder layers (B 2, 1,500 frames, 64 decoder
   tokens; the encoder's non-causal attention and the decoder's
   cross-attention through the kernel) and qwen2-vl-72b with one layer
   (B 1, S 512, 256 patch embeddings over a 16 x 16 grid of
   ``positions3``): prefill logits, four teacher-forced decode steps'
   logits and the whole state (``kv``, ``kv_first``, ``cross``, ``rnn``)
   agree, and each zoo kernel launched as ``zoo_launches`` says (once a
   layer; encdec: ``flash_attention`` once an encoder layer, twice a
   decoder layer);
4s. the serve path at full width and depth: ``ServeEngine`` on the card in
   bfloat16 with random weights, hymba-1.5b then rwkv6-7b, 4 requests of
   2048 tokens in 4 slots, 16 new tokens each: 32 launches of
   ``flash_attention`` and ``ssd_scan`` (hymba) or ``rwkv6_scan`` (rwkv6)
   at the admit, every logit finite, every token in the vocabulary, every
   request done; prefill seconds, decode ms per tick, tokens per second
   and peak memory; then a second admit and three ticks under
   torch.profiler (device busy share, the costliest device ops and the
   port's kernels); then moonshot-v1-16b-a3b whole (27.6 B params, 48
   launches an admit, profiled the same way with the MoE's dispatch,
   experts and combine timed by their labels) and qwen2-vl-72b at full
   width cut to 20 of its 80 layers (20 launches), both through
   ``ServeEngine``, and whisper-large-v3 whole through ``prefill_fn`` and
   ``decode_fn`` (4 x 1,500 frames, 4 decoder prompt tokens, 16 greedy
   tokens; 96 launches);
5z. the serve entry point, ``repro_torch.launch.serve --arch hymba-1.5b``
   (smoke config) on the card and on the CPU with the same request and
   token counts, the same for moonshot-v1-16b-a3b and mixtral-8x22b,
   then ``--full --prompt-len 2048`` on the card for hymba-1.5b, rwkv6-7b
   and moonshot-v1-16b-a3b;
4t. training: one step of each family's smoke config (smollm-135m,
   moonshot-v1-16b-a3b, hymba-1.5b, rwkv6-7b, qwen2-vl-72b,
   whisper-large-v3) in float32 with TF32 off, seeded weights and one
   batch, through ``Model.loss_fn`` (the kernels in its forward, the
   autograd wrappers recomputing the reference's plain forms backward) and
   one AdamW step on the card, against the same in the worker processes on
   the CPU: loss, aux, every gradient leaf, the moments and the update of
   the params after the step within the CPU tests' tolerances, and each
   zoo kernel launched once a layer a forward (``train_launches``: the forward, then the
   ``remat="full"`` recompute); then hymba-1.5b whole and rwkv6-7b at full
   width cut to 8 of 32 layers in bfloat16, B 4 x S 2048, one warm-up and
   3 timed steps (ms a step, tokens/s, peak memory) and one profiled step
   (busy share, the costliest device ops); then ``python -m
   repro_torch.launch.train --arch smollm-135m --full --steps 30`` on the
   card, whose last 10 steps' mean loss is below its first 10's;
4r. the roofline: the dry run (``launch/dryrun.py``, on ``meta`` with a
   one-chip mesh) counts the steps phases 4t and 4s timed (hymba-1.5b
   whole and rwkv6-7b at 8 layers, train, B 4 x S 2048, remat "full"; the
   hymba, rwkv6 and moonshot admits of 4 x 2048) and prints each one's
   compute and memory terms on the H100's constants, the bound (the
   larger), ``useful_ratio``, the measured ms, measured / bound and
   model_flops / peak / measured; it fails if a measured step beats its
   bound. Then the dry run of smollm-135m's train_4k on the two-pod mesh
   into a temporary directory (its all-reduce bytes nonzero), whose record
   ``simulate workload`` runs on the card and on the CPU: equal lines,
   ``maxmin_rates`` launched;
6. a JSON line of the kernels, then the card's name and power limit, then
   the result line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
# Every kernel: its CUDA source and the TPU kernel it replaces (the JSON
# line and PERF.md's table).
_ES = "src/repro_torch/kernels/csrc/event_select.cu"
_TPU_ES = "src/repro/kernels/event_select.py"
KERNELS = {
    "select_events": dict(source=_ES, replaces=f"{_TPU_ES}:51"),
    "group_by_kind": dict(source=_ES, replaces=f"{_TPU_ES}:125"),
    "trace_rank": dict(source=_ES, replaces=f"{_TPU_ES}:249"),
    "route_rank": dict(source=_ES, replaces=f"{_TPU_ES}:287"),
    "ring_slots": dict(source=_ES, replaces=f"{_TPU_ES}:185"),
    "fused_select": dict(source=_ES, replaces=f"{_TPU_ES}:395"),
    "maxmin_rates": dict(
        source="src/repro_torch/kernels/csrc/bandwidth_share.cu",
        replaces="src/repro/kernels/bandwidth_share.py:21"),
    "flash_attention": dict(
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:27"),
    "rwkv6_scan": dict(source="src/repro_torch/kernels/csrc/rwkv6_scan.cu",
                       replaces="src/repro/kernels/rwkv6_scan.py:22"),
    "ssd_scan": dict(source="src/repro_torch/kernels/csrc/rwkv6_scan.cu",
                     replaces="src/repro/kernels/rwkv6_scan.py:69"),
}
# H100 SXM: 3.35 TB/s of HBM; int32 ALU issue 64 ops/clk/SM x 132 SMs x
# 1.98 GHz = 16.7 Tops/s (half the float32 lanes of the 67 TFLOP/s peak,
# which counts an FMA as two operations); float32 outside the tensor cores
# 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.7e12
FP32_OPS_PER_S = 67e12
# bf16 on the tensor cores, dense (the model zoo's attention in bfloat16)
BF16_OPS_PER_S = 989e12
# TF32 on the tensor cores, dense (rwkv6_scan in bfloat16)
TF32_OPS_PER_S = 495e12

# The tiered Grid's source: WLCG's tier shape (wlcg.web.cern.ch, "Tier
# centres": one Tier-0, 13 Tier-1 centres, about 170 Tier-2 sites), cut to 4
# Tier-2 sites per Tier-1; the builder calls of `simulate t0t1`.
N_T1, T2_PER_T1 = 13, 4
# Phase 4t's full-width steps: (arch, layer cut), bfloat16, B x S, remat
# "full"; phase 4r bounds them and the admits of ROOFLINE_ADMITS (phase 4s)
# by the dry run's count on a one-chip mesh.
TRAIN_FULL = (("hymba-1.5b", {}), ("rwkv6-7b", dict(n_layers=8)))
TRAIN_B, TRAIN_S, TRAIN_TIMED = 4, 2048, 3
# Phase 4t's causal schemes: hymba-1.5b at full width, B x S of train_4k's
# length with 4t's token count, chunks 2,048 / 1,024 as configured: two
# query chunks over four key chunks, 8 visits a layer in "rect", 5 in
# "tri" (window 1,024). At 4t's S = 2,048 there is one query chunk, and
# "tri" and "rect" are the same work, so that shape checks nothing.
TRI_ARCH, TRI_B, TRI_S = "hymba-1.5b", 2, 4096
# The two steps run in float32 with TF32 off: in bfloat16 a last-bit
# difference in the recompute's float32 sums flips a rounding now and then,
# and 32 layers of bfloat16 backward spread it (the embedding's gradient
# 5.49e-4 apart on the card). Their gradients agree within the float32
# tolerance of the JAX suite's attention tests, in its form
# (tests/test_kernels.py::test_flash_attention_sweep: |a - b| <= atol +
# rtol * |b|, atol = rtol = 2e-6); the largest difference over each leaf's
# scale is printed beside it (2.5e-6 on the card: the first layers' leaves,
# at the end of the backward).
TRI_DTYPE, TRI_TOL = "float32", 2e-6
ROOFLINE_ADMITS = ("hymba-1.5b", "rwkv6-7b", "moonshot-v1-16b-a3b")
ONE_CHIP = {"data": 1, "model": 1}
# Phase 4t's families: one train step each at its smoke config in float32,
# the card (kernels) against the CPU run of the worker processes (plain
# versions), on the same weights and batch.
TRAIN_FAMILIES = ("smollm-135m", "moonshot-v1-16b-a3b", "hymba-1.5b",
                  "rwkv6-7b", "qwen2-vl-72b", "whisper-large-v3")
# phase 4h's shards over the card(s): 8 agents, K = 2
DIST_D = 4
# phase 5's `simulate t0t1` configurations, each at two of the CLI's four
# bandwidths: 8.0 MB a tick (no stale event) and 2.0 (stale events)
T0T1_BW = ["--bandwidths", "8.0", "2.0"]
T0T1_RUNS = {"1": ["--agents", "1", *T0T1_BW],
             "4": ["--agents", "4", *T0T1_BW],
             "4 fused": ["--agents", "4", "--fused-select", *T0T1_BW],
             "4 ref dense": ["--agents", "4", "--insert-mode", "ref",
                             "--merge-mode", "dense", *T0T1_BW],
             "4 adaptive": ["--agents", "4", "--adaptive-exec", *T0T1_BW]}


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def tiered_grid(components, n_t1: int = N_T1, t2_per_t1: int = T2_PER_T1,
                t1_count: int = 64, t2_count: int = 32):
    """The tiered Grid through a ``components`` module's ScenarioBuilder
    (any package with the reference's builder API). Returns the builder."""
    c = components
    b = c.ScenarioBuilder(max_cpu=16, queue_cap=32, max_link=4, max_flow=32)
    b.add_regional_center(n_cpu=16, cpu_power=10.0, disk=20000.0,
                          tape=200000.0, tape_rate=5.0)
    for _ in range(n_t1):
        t1 = b.add_regional_center(n_cpu=16, cpu_power=8.0, disk=2000.0,
                                   tape=20000.0, tape_rate=5.0)

        def payload(size):
            return c.FLOW_START.pack(
                size=size, l0=0, notify_lp=t1["farm"],
                notify_kind=c.JOB_SUBMIT.id, notify2_lp=t1["storage"],
                notify2_kind=c.DATA_WRITE.id)

        wan = b.add_net_region([2.0, 2.0], [5, 5])
        b.add_generator(target_lp=wan, kind=c.FLOW_START,
                        payload=payload(40.0), interval=15, count=t1_count)
        for _ in range(t2_per_t1):
            wan2 = b.add_net_region([0.5, 0.5], [8, 8])
            b.add_generator(target_lp=wan2, kind=c.FLOW_START,
                            payload=payload(20.0), interval=30,
                            count=t2_count)
    return b


def tiered_build_kw(n_agents: int = 8, pool_cap: int = 4096) -> dict:
    return dict(n_agents=n_agents, lookahead=2, t_end=100_000,
                pool_cap=pool_cap, work_per_mb=2.0)


# --------------------------------------------------------------- phase 3
def cuda_ms(fn, iters: int = 200) -> float:
    """Mean time of ``fn()`` on the card, CUDA events after a warm-up."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(fn, kernel: str, iters: int = 20, repeats: int = 5) -> float:
    """The kernel's own device time per launch: ``iters`` calls of ``fn``
    under torch.profiler, the device time of the ops whose name contains
    ``kernel`` (one a call) over their count. A profile can lose records
    (CUPTI holds back those it has not completed when the profile stops),
    so the profile repeats, up to ``repeats`` times, until half the
    launches are recorded; the mean is over the records held. Beside ``cuda_ms``, which
    also counts the wrapper's host time when that is the longer."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    us = []
    for _ in range(repeats):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us += [e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA and kernel in e.name]
        if len(us) >= iters // 2:
            break
    if not us:
        raise AssertionError(f"{kernel}: no device op in {repeats} "
                             f"profiles of {iters} calls")
    return sum(us) / 1e3 / len(us)


def bound(n_bytes: float, n_ops: float,
          ops_per_s: float = INT32_OPS_PER_S) -> tuple[float, str]:
    """The least time in ms for ``n_bytes`` of HBM traffic and ``n_ops``
    operations at ``ops_per_s``, and which of the two bounds it."""
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    to = n_ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def kernel_modules():
    """The wrapper modules, each with a ``LAUNCHES`` dict."""
    from repro_torch.kernels import (bandwidth_share, event_select,
                                     flash_attention, rwkv6_scan)
    return event_select, bandwidth_share, flash_attention, rwkv6_scan


def reset_launches() -> None:
    for m in kernel_modules():
        m.reset_launches()


def launches() -> dict:
    return {k: v for m in kernel_modules() for k, v in m.LAUNCHES.items()}


def max_err(got, want) -> int:
    import torch
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    err = 0
    for g, w in zip(got, want):
        g = g.cpu()
        w = w.cpu()
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape} {g.dtype} vs "
                                 f"{w.shape} {w.dtype}")
        if not torch.equal(g, w):
            raise AssertionError("kernel output differs from its plain "
                                 "version")
        err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def select_pool(ri, mode, A, cap, m):
    """(A, cap) int32 time keys and seqs on the card for a select_events
    case, the pools of tests/test_torch_select.py."""
    import torch
    from repro_torch.kernels import ref
    T_INF = 2**31 - 1

    def perm(n):   # a random permutation of each row's slots
        return torch.argsort(ri(0, 1 << 30, (A, cap)), dim=1)[:, :n]

    tk, sq = ri(0, 64, (A, cap)), ri(0, 1 << 20, (A, cap))
    if mode == "rand":
        tk = torch.where(ri(0, 4, (A, cap)) == 0, T_INF, tk)
    elif mode == "unsafe":
        tk = torch.full_like(tk, T_INF)
    elif mode == "ties":
        tk, sq = torch.full_like(tk, 7), torch.full_like(sq, 3)
    elif mode == "one_time":
        tk, sq = torch.full_like(tk, 5), perm(cap).int()
    elif mode == "neg_seq":
        sq = ri(-2**31, 2**31 - 1, (A, cap))
        tk = torch.where(ri(0, 2, (A, cap)) == 0, T_INF, tk)
    elif mode == "full_range":
        tk, sq = ri(-2**31, 2**31 - 1, (A, cap)), ri(-2**31, 2**31 - 1,
                                                     (A, cap))
    elif mode == "few_keys":   # 16 keys: the boundary key repeats across m
        tk, sq = ri(0, 4, (A, cap)), ri(0, 4, (A, cap))
    elif mode == "boundary":   # the m-th key copied onto 40 slots
        b = ref.sort_events(tk, sq)[:, m - 1:m].long()
        at = perm(40)
        tk = tk.scatter(1, at, tk.gather(1, b).expand(-1, 40))
        sq = sq.scatter(1, at, sq.gather(1, b).expand(-1, 40))
    return tk.contiguous(), sq.contiguous()


def phase_kernels(es, ref) -> dict:
    import torch
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    T_INF = 2**31 - 1
    A = 8

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g,
                             dtype=torch.int32).to(dev)

    err = {k: 0 for k in es.LAUNCHES}
    # select (the radix selection for 2m <= min(n_pad, 1024), else the
    # bitonic sort): random keys with unsafe (T_INF) slots, all unsafe, all
    # ties, one time with distinct seqs, negative seqs, the full int32
    # range, 16 distinct keys, the m-th key copied onto 40 slots; caps
    # 1000 / 4096 / 16384; m = 1, 512 and 513 (the threshold), m = cap,
    # exec_cap > cap (tests/test_torch_select.py models the same pools)
    for cap, m, mode in [(4096, 256, "rand"), (1000, 256, "rand"),
                         (16384, 256, "rand"), (4096, 256, "unsafe"),
                         (4096, 256, "ties"), (1000, 1500, "rand"),
                         (256, 256, "rand"), (4096, 256, "one_time"),
                         (4096, 256, "neg_seq"), (4096, 256, "full_range"),
                         (4096, 256, "few_keys"), (4096, 256, "boundary"),
                         (1000, 256, "ties"), (16384, 256, "neg_seq"),
                         (16384, 256, "few_keys"), (4096, 1, "rand"),
                         (4096, 1, "ties"), (4096, 512, "rand"),
                         (4096, 512, "boundary"), (4096, 513, "rand"),
                         (4096, 4096, "rand"), (33, 16, "ties")]:
        tk, sq = select_pool(ri, mode, A, cap, min(m, cap))
        err["select_events"] = max(err["select_events"], max_err(
            es.select_events(tk, sq, m), ref.select_events(tk, sq, m)))
        print(f"[kernels] select_events cap={cap} exec_cap={m} {mode}: equal",
              flush=True)
    # group: 256 rows, 8 kinds (also out-of-range kinds), all inactive,
    # all one kind
    for mode in ("rand", "inactive", "one_kind"):
        kd = ri(-1, 10, (A, 256))
        ac = ri(0, 2, (A, 256))
        if mode == "inactive":
            ac = torch.zeros_like(ac)
        elif mode == "one_kind":
            kd, ac = torch.full_like(kd, 3), torch.ones_like(ac)
        err["group_by_kind"] = max(err["group_by_kind"], max_err(
            es.group_by_kind(kd, ac, 8), ref.group_by_kind(kd, ac, 8)))
        print(f"[kernels] group_by_kind m=256 n_kinds=8 {mode}: equal",
              flush=True)
    # trace: int32 masks, and bool and uint8 ones (the engine's exec_safe,
    # read as it comes), also through ops as the engine calls it
    for mode in ("rand", "none", "all"):
        mk = {"rand": ri(0, 2, (A, 256)),
              "none": torch.zeros((A, 256), dtype=torch.int32, device=dev),
              "all": torch.ones((A, 256), dtype=torch.int32, device=dev)}[mode]
        for m_dt in (torch.int32, torch.bool, torch.uint8):
            x = mk.to(m_dt)
            err["trace_rank"] = max(err["trace_rank"], max_err(
                es.trace_rank(x), ref.trace_rank(x)))
        err["trace_rank"] = max(err["trace_rank"], max_err(
            ops.trace_rank(mk.bool()), ref.trace_rank(mk.bool())))
        print(f"[kernels] trace_rank n=256 {mode} (int32, bool, uint8, "
              f"ops bool): equal", flush=True)
    for mode in ("rand", "sentinel", "one"):
        d = ri(0, 9, (A, 4096))
        if mode == "sentinel":
            d = torch.where(ri(0, 4, (A, 4096)) > 0, 8, d)
        elif mode == "one":
            d = torch.full_like(d, 2)
        err["route_rank"] = max(err["route_rank"], max_err(
            es.route_rank(d, 9), ref.route_rank(d)))
        print(f"[kernels] route_rank n=4096 buckets=9 {mode}: equal",
              flush=True)

    err["route_rank"] = max(err["route_rank"],
                            check_route_rank(es, ops, ref, ri))
    err["group_by_kind"] = max(err["group_by_kind"],
                               check_group_by_kind(es, ops, ref, ri))
    err["ring_slots"] = check_ring_slots(es, ref, ri)
    err["ring_slots"] = max(err["ring_slots"],
                            check_ring_edges(es, ops, ref, ri))
    err["fused_select"] = check_fused_select(es, ref, ri, g)

    # timing at the main path's shapes
    cap, m, nk, n_emit, nb = 4096, 256, 8, 4096, 9
    tk = torch.where(ri(0, 4, (A, cap)) == 0, T_INF, ri(0, 64, (A, cap)))
    sq = ri(0, 1 << 20, (A, cap))
    kd, ac = ri(0, nk, (A, m)), ri(0, 2, (A, m))
    acb = ac.bool()
    mk = ri(0, 2, (A, m))
    dd = ri(0, nb, (A, n_emit))
    key = torch.where(ac.bool(), kd, nk)
    log_m = m.bit_length() - 1
    # the stable sort of the packed (time_key << 32) | seq key is one
    # PyTorch call for select_events (both halves are non-negative, so the
    # int64 order is the (time, seq) order; ties fall to the slot index as
    # in the kernel); the pack is outside the timing
    assert int(tk.min()) >= 0 and int(sq.min()) >= 0
    packed = (tk.long() << 32) | sq.long()
    assert torch.equal(torch.argsort(packed, dim=1, stable=True)[:, :m].int(),
                       ref.select_events(tk, sq, m))
    fs_in, fs_kw = fused_inputs(ri, g, A, cap, 0.6, 4000)
    ring = torch.stack([torch.randperm(cap, generator=g)
                        for _ in range(A)]).to(torch.int32).to(dev)
    head = ri(0, cap, (A,))
    want = ri(0, 2, (A, n_emit)).bool()
    n_pay, fs_nk = fs_in[8].shape[-1], fs_kw["n_kinds"]
    rows = {
        "select_events": dict(
            fn=lambda: es.select_events(tk, sq, m),
            plain=lambda: ref.select_events(tk, sq, m),
            lib=lambda: torch.argsort(packed, dim=1, stable=True)[:, :m],
            # a selection looks at every key once and orders the m it keeps
            bytes=A * cap * 8 + A * m * 4, ops=A * (cap + m * log_m)),
        "fused_select": dict(
            fn=lambda: es.fused_select(*fs_in, m, **fs_kw),
            plain=lambda: ref.fused_select(*fs_in, m, **fs_kw), lib=None,
            # reads time_key and seq over the pool, the cursor, and 7 int32
            # columns, 2 bool and the payload of the m window lanes; writes
            # 9 int32 columns, 3 bool and the payload of the window lanes
            # and the per-kind counts
            bytes=(A * (cap * 8 + 4 + m * (7 * 4 + 2 + 4 * n_pay))
                   + A * m * (9 * 4 + 3 + 4 * n_pay) + A * fs_nk * 4),
            # a selection (each key once, m log m to order the kept), the
            # conflict sort of the m lanes, the ranks
            ops=A * (cap + 2 * m * log_m + m * (fs_nk + 2)),
            kernel="fused_select_radix_kernel"),
        "ring_slots": dict(
            fn=lambda: es.ring_slots(ring, head, want),
            plain=lambda: ref.ring_slots(ring, head, want), lib=None,
            # the wanted rows' ring entries (as many as are wanted, at most
            # the ring), the head, the mask and the slots
            bytes=(4 * int(want.sum(1).clamp(max=cap).sum())
                   + A * (4 + n_emit * 5)), ops=A * n_emit * 2),
        # the engine's call: ops on int32 kinds and the bool clean mask
        "group_by_kind": dict(
            fn=lambda: ops.group_by_kind(kd, acb, nk),
            plain=lambda: ref.group_by_kind(kd, acb, nk),
            lib=lambda: torch.argsort(key, dim=1, stable=True),
            # int32 kinds and a byte a row of the mask read, order and rank
            # and the counts written
            bytes=A * m * (4 + 1 + 8) + A * nk * 4, ops=A * m * (nk + 1)),
        "trace_rank": dict(
            fn=lambda: es.trace_rank(mk), plain=lambda: ref.trace_rank(mk),
            lib=lambda: torch.cumsum(mk, dim=1, dtype=torch.int32),
            bytes=A * m * 8, ops=A * m),
        # the stable sort by bucket: the grouping the ranks need, one call;
        # the kernel looks at each key once
        "route_rank": dict(
            fn=lambda: es.route_rank(dd, nb), plain=lambda: ref.route_rank(dd),
            lib=lambda: torch.argsort(dd, dim=1, stable=True),
            bytes=A * n_emit * 8, ops=A * n_emit),
    }
    out = {}
    for name, r in rows.items():
        ms = cuda_ms(r["fn"])
        dev_ms = device_ms(r["fn"], r.get("kernel", f"{name}_kernel"))
        plain_ms = cuda_ms(r["plain"])
        lib_ms = cuda_ms(r["lib"]) if r["lib"] is not None else None
        bms, by = bound(r["bytes"], r["ops"])
        out[name] = dict(max_abs_err=err[name], ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                         bound_by=by)
        print(f"[kernels] {name}: kernel {ms:.6f} ms (device {dev_ms:.6f} "
              f"ms), plain {plain_ms:.6f} ms, library "
              f"{lib_ms if lib_ms is None else f'{lib_ms:.6f}'} ms, "
              f"bound {bms:.9f} ms ({by})", flush=True)
    trace_rank_call(es, ops, mk, out["trace_rank"])
    group_call(es, ops, kd, acb, nk, out["group_by_kind"])
    ring_call(es, ops, ring, head, want, out["ring_slots"])
    route_call(es, ops, dd, nb, out["route_rank"])
    return out


def host_us(fn, n: int = 5000) -> float:
    """Mean host time of ``fn()`` in microseconds over ``n`` calls
    (``time.perf_counter``), after a warm-up, the card idle before and
    synchronised after."""
    import torch
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def in_turns(label: str, fns: dict, rounds: int = 5) -> dict:
    """``cuda_ms`` of each function in ``fns`` in turns, ``rounds`` times
    (the host's time moves between timings); prints and returns the
    medians."""
    times = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            times[k].append(cuda_ms(fn))
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    print(f"[kernels] {label} in turns: " + "; ".join(
        f"{k} median {med[k]:.6f} ms, rounds {[round(x, 6) for x in v]}"
        for k, v in times.items()), flush=True)
    return med


def trace_rank_call(es, ops, mk, row: dict) -> None:
    """trace_rank as the engine calls it (``ops.trace_rank`` on a bool
    (8, 256) mask) beside the int32 row, against ``cumsum`` of the same
    mask; then where a call's host time goes, piece by piece (the mean
    ``time.perf_counter`` of each piece alone). Adds the engine-shaped
    times to ``row``."""
    import torch
    mb = mk.bool()
    A, n = mb.shape
    ms = cuda_ms(lambda: ops.trace_rank(mb))
    dev_ms = device_ms(lambda: ops.trace_rank(mb), "trace_rank_kernel")
    before_ms = cuda_ms(lambda: es.trace_rank(mb.to(torch.int32)
                                              .contiguous()))
    lib_ms = cuda_ms(lambda: torch.cumsum(mb, dim=1, dtype=torch.int32))
    row.update(engine_ms=ms, engine_device_ms=dev_ms,
               engine_library_ms=lib_ms)
    print(f"[kernels] trace_rank as the engine calls it (ops, bool "
          f"{A}x{n}): {ms:.6f} ms (device {dev_ms:.6f} ms); with the int32 "
          f"copy the port made before: {before_ms:.6f} ms; cumsum of the "
          f"bool mask {lib_ms:.6f} ms", flush=True)
    # the call against cumsum in turns, for each mask
    for what, x, fn in (("int32", mk, lambda: es.trace_rank(mk)),
                        ("bool, ops", mb, lambda: ops.trace_rank(mb))):
        med = in_turns(f"trace_rank ({what}) against cumsum",
                       {"kernel": fn,
                        "cumsum": lambda x=x: torch.cumsum(
                            x, dim=1, dtype=torch.int32)})
        ratio = med["kernel"] / med["cumsum"]
        print(f"[kernels] trace_rank ({what}): {ratio:.3f}x cumsum's time",
              flush=True)
    lib = es._lib()
    out = torch.empty_like(mb, dtype=torch.int32)
    pm, po, stream = mb.data_ptr(), out.data_ptr(), es._stream(mb)
    pieces = {
        "check": lambda: es._check_mask(mb),
        "allocation": lambda: torch.empty_like(mb, dtype=torch.int32),
        "stream (raw handle)": lambda: es._stream(mb),
        "stream (torch.cuda.current_stream, as before)":
            lambda: torch.cuda.current_stream().cuda_stream,
        "data_ptr x2": lambda: (mb.data_ptr(), out.data_ptr()),
        "ctypes call (the launch)":
            lambda: lib.launch_trace_rank(pm, 1, po, A, n, stream),
        "cast to int32 (ops before)":
            lambda: mb.to(torch.int32).contiguous(),
        "whole: es.trace_rank(bool)": lambda: es.trace_rank(mb),
        "whole: es.trace_rank(int32)": lambda: es.trace_rank(mk),
        "whole: ops.trace_rank(bool), the engine's":
            lambda: ops.trace_rank(mb),
        "whole: cumsum (bool)":
            lambda: torch.cumsum(mb, dim=1, dtype=torch.int32),
    }
    for what, fn in pieces.items():
        print(f"[kernels] trace_rank call path: {what}: "
              f"{host_us(fn):.3f} us host", flush=True)


def group_call(es, ops, kd, acb, nk: int, row: dict) -> None:
    """group_by_kind beside the engine's call (``row``, ``ops`` on the bool
    mask): the direct call with a bool and an int32 mask, the former call
    path (ops' int32 copy of the mask, a check of two tensors, three
    allocations) around the same kernel, in turns; then where a call's host
    time goes, piece by piece. Adds the direct call's times to ``row``."""
    import torch
    A, m = kd.shape
    lib = es._lib()
    ac = acb.to(torch.int32)
    n_out = 2 * A * m + A * nk

    def as_before():
        k, a32 = kd.to(torch.int32).contiguous(), acb.to(torch.int32)
        es._check("group_by_kind", k, a32.contiguous())
        if not 1 <= nk <= es.MAX_KINDS:
            raise ValueError(nk)
        o, r = torch.empty_like(k), torch.empty_like(k)
        c = torch.empty((A, nk), dtype=torch.int32, device=k.device)
        es._launch("group_by_kind", lib.launch_group_by_kind, k,
                   k.data_ptr(), a32.data_ptr(), 4, o.data_ptr(),
                   r.data_ptr(), c.data_ptr(), A, m, nk)
        return o, r, c

    direct_ms = cuda_ms(lambda: es.group_by_kind(kd, acb, nk))
    direct_dev = device_ms(lambda: es.group_by_kind(kd, acb, nk),
                           "group_by_kind_kernel")
    int32_ms = cuda_ms(lambda: es.group_by_kind(kd, ac, nk))
    buf = torch.empty(n_out, dtype=torch.int32, device=kd.device)
    p, stream = buf.data_ptr(), es._stream(kd)
    args = (kd.data_ptr(), acb.data_ptr(), 1, p, p + 4 * A * m,
            p + 8 * A * m, A, m, nk, stream)
    row.update(direct_ms=direct_ms, direct_device_ms=direct_dev,
               int32_ms=int32_ms)
    print(f"[kernels] group_by_kind ({A}x{m}, {nk} kinds): the engine's call "
          f"(ops, bool mask) {row['ms']:.6f} ms (device "
          f"{row['device_ms']:.6f} ms); direct, bool mask {direct_ms:.6f} ms "
          f"(device {direct_dev:.6f} ms); direct, int32 mask {int32_ms:.6f} "
          f"ms", flush=True)
    in_turns("group_by_kind, the engine's call against the former call path",
             {"ops.group_by_kind(bool)": lambda: ops.group_by_kind(kd, acb,
                                                                   nk),
              "the former call path": as_before})
    pieces = {
        "check (one pass)": lambda: es._check_group(kd, acb, nk),
        "checks as before (two tensors, n_kinds)": lambda: (
            es._check("group_by_kind", kd, ac), 1 <= nk <= es.MAX_KINDS),
        "allocation: new_empty (one buffer)": lambda: kd.new_empty(n_out),
        "allocation: torch.empty(device=) (one buffer)": lambda: torch.empty(
            n_out, dtype=torch.int32, device=kd.device),
        "allocation: empty_like (an (A, m) tensor)":
            lambda: torch.empty_like(kd),
        "allocations as before (three)": lambda: (
            torch.empty_like(kd), torch.empty_like(kd),
            torch.empty((A, nk), dtype=torch.int32, device=kd.device)),
        "views: as_strided x3 (the wrapper's)": lambda: (
            buf.as_strided((A, m), (m, 1)),
            buf.as_strided((A, m), (m, 1), A * m),
            buf.as_strided((A, nk), (nk, 1), 2 * A * m)),
        "views: split_with_sizes, view x3": lambda: [
            t.view(-1, n) for t, n in zip(
                buf.split_with_sizes((A * m, A * m, A * nk)), (m, m, nk))],
        "stream (raw handle)": lambda: es._stream(kd),
        "data_ptr x3": lambda: (kd.data_ptr(), acb.data_ptr(),
                                buf.data_ptr()),
        "ctypes call (the launch)": lambda: lib.launch_group_by_kind(*args),
        "ops' casts as before (kinds, the mask to int32)": lambda: (
            kd.to(torch.int32).contiguous(),
            acb.to(torch.int32).contiguous()),
        "ops' conversions now (kinds, the bool mask as it is)": lambda: (
            ops._i32(kd), acb.contiguous()),
        "whole: es.group_by_kind(bool)": lambda: es.group_by_kind(kd, acb,
                                                                  nk),
        "whole: ops.group_by_kind(bool), the engine's":
            lambda: ops.group_by_kind(kd, acb, nk),
        "whole: the former call path": as_before,
    }
    for what, fn in pieces.items():
        print(f"[kernels] group_by_kind call path: {what}: "
              f"{host_us(fn):.3f} us host", flush=True)


def ring_call(es, ops, ring, head, want, row: dict) -> None:
    """ring_slots as the engine calls it (``ops``) against the former call
    path (three checks, the shape check, ``torch.empty``) around the same
    kernel, in turns; then where a call's host time goes, piece by
    piece."""
    import torch
    A, cap = ring.shape
    n = want.shape[1]
    lib = es._lib()
    out = torch.empty_like(want, dtype=torch.int32)
    stream = es._stream(want)
    ptrs = (ring.data_ptr(), head.data_ptr(), want.data_ptr(),
            out.data_ptr())

    def checks_before():
        es._check("ring_slots", ring)
        es._check("ring_slots", want, dtype=torch.bool)
        if want.shape[0] != A:
            raise ValueError(A)
        es._check_cursor("ring_slots", head, A)

    def as_before():
        r, h, w = (ring.to(torch.int32).contiguous(),
                   head.to(torch.int32).contiguous(), want.bool().contiguous())
        checks_before()
        o = torch.empty(w.shape, dtype=torch.int32, device=w.device)
        es._launch("ring_slots", lib.launch_ring_slots, w, r.data_ptr(),
                   h.data_ptr(), w.data_ptr(), o.data_ptr(), A, cap, n)
        return o

    ops_ms = cuda_ms(lambda: ops.ring_slots(ring, head, want))
    row.update(engine_ms=ops_ms)
    print(f"[kernels] ring_slots ({A}x{n} over a {cap} ring): the engine's "
          f"call (ops) {ops_ms:.6f} ms; direct {row['ms']:.6f} ms (device "
          f"{row['device_ms']:.6f} ms)", flush=True)
    in_turns("ring_slots, the engine's call against the former call path",
             {"ops.ring_slots": lambda: ops.ring_slots(ring, head, want),
              "the former call path": as_before})
    pieces = {
        "check (one pass)": lambda: es._check_ring(ring, head, want),
        "checks as before (three, and the shape)": checks_before,
        "allocation: empty_like": lambda: torch.empty_like(
            want, dtype=torch.int32),
        "allocation: new_empty": lambda: want.new_empty(
            want.shape, dtype=torch.int32),
        "allocation: torch.empty(device=)": lambda: torch.empty(
            want.shape, dtype=torch.int32, device=want.device),
        "stream (raw handle)": lambda: es._stream(want),
        "data_ptr x4": lambda: (ring.data_ptr(), head.data_ptr(),
                                want.data_ptr(), out.data_ptr()),
        "ctypes call (the launch)": lambda: lib.launch_ring_slots(
            *ptrs, A, cap, n, stream),
        "ops' conversions as before": lambda: (
            ring.to(torch.int32).contiguous(),
            head.to(torch.int32).contiguous(), want.bool().contiguous()),
        "ops' conversions now": lambda: (ops._i32(ring), ops._i32(head),
                                         ops._bool(want)),
        "whole: es.ring_slots": lambda: es.ring_slots(ring, head, want),
        "whole: ops.ring_slots, the engine's":
            lambda: ops.ring_slots(ring, head, want),
        "whole: the former call path": as_before,
    }
    for what, fn in pieces.items():
        print(f"[kernels] ring_slots call path: {what}: "
              f"{host_us(fn):.3f} us host", flush=True)


def engine_route_input(windows: int = 60):
    """The ``dst_agent`` that ``route_rank`` gets from the engine: stitched
    ``tiered_grid`` on the card for ``windows`` windows, captured through
    ``Engine(route_fn=...)`` by a function that records its input and then
    calls ``ops.route_rank`` as the engine's default does. Returns the input
    of the window with the median count of valid rows (those below the
    sentinel A) among the windows that routed any, and that count."""
    import torch
    from repro_torch.core import components as comps
    from repro_torch.core import Engine
    from repro_torch.kernels import ops
    world, own, init_ev, spec = tiered_grid(comps).build(**tiered_build_kw())
    seen = []

    def record(dst_agent):
        seen.append(dst_agent.clone())
        return ops.route_rank(dst_agent, spec.n_agents + 1)

    Engine(world, own, init_ev, spec, trace_cap=65536, route_fn=record,
           device="cuda").run_local(max_windows=windows)
    valid = [int((d < spec.n_agents).sum()) for d in seen]
    routed = sorted((v, w) for w, v in enumerate(valid) if v > 0)
    if not routed:
        raise AssertionError(f"no emit routed in {windows} windows")
    v, w = routed[len(routed) // 2]
    d = seen[w]
    print(f"[kernels] route_rank's engine input: {len(seen)} route calls in "
          f"{windows} stitched tiered_grid windows, {len(routed)} with valid "
          f"rows (valid rows a call: min {routed[0][0]}, median {v}, max "
          f"{routed[-1][0]}); window {w}: {tuple(d.shape)}, {v} valid rows, "
          f"per agent {(d < spec.n_agents).sum(1).tolist()}, the rest the "
          f"sentinel {spec.n_agents}", flush=True)
    return d, v


def route_call(es, ops, dd, nb: int, row: dict) -> None:
    """route_rank on the engine's own input (``engine_route_input``) beside
    the uniform buckets of ``row``; then the call against the former call
    path (the shape check, ``max_keys()`` through ctypes on every call) around
    the same kernel in turns, and where a call's host time goes, piece by
    piece. Adds the engine input's times to ``row``."""
    import torch
    from repro_torch.kernels import ref
    de, n_valid = engine_route_input()
    A, n = dd.shape
    lib = es._lib()
    out = torch.empty_like(dd)
    stream = es._stream(dd)
    pd, po = dd.data_ptr(), out.data_ptr()
    if not torch.equal(es.route_rank(de, nb), ref.route_rank(de)):
        raise AssertionError("route_rank differs on the engine's input")

    def as_before():
        es._check("route_rank", dd)
        lib_ = es._lib()
        if not 1 <= nb <= lib_.max_keys():
            raise ValueError(nb)
        o = torch.empty_like(dd)
        es._launch("route_rank", lib_.launch_route_rank, dd, es._ptr(dd),
                   es._ptr(o), A, n, nb)
        return o

    ms = cuda_ms(lambda: ops.route_rank(de, nb))
    dev_ms = device_ms(lambda: ops.route_rank(de, nb), "route_rank_kernel")
    lib_ms = cuda_ms(lambda: torch.argsort(de, dim=1, stable=True))
    row.update(engine_ms=ms, engine_device_ms=dev_ms,
               engine_library_ms=lib_ms, engine_valid_rows=n_valid)
    print(f"[kernels] route_rank on the engine's input ({A}x{n}, {n_valid} "
          f"valid rows; ops): {ms:.6f} ms (device {dev_ms:.6f} ms); stable "
          f"argsort {lib_ms:.6f} ms; on uniform buckets {row['ms']:.6f} ms "
          f"(device {row['device_ms']:.6f} ms)", flush=True)
    in_turns("route_rank, the call against the former call path",
             {"es.route_rank": lambda: es.route_rank(dd, nb),
              "the former call path": as_before})
    row.update(route_walks(es, dd, de, nb))
    pieces = {
        "check (_check, the shape and n_buckets, max_keys read once)":
            lambda: (es._check("route_rank", dd),
                     dd.dim() != 2 or not 1 <= nb <= es._max_keys()),
        "check as before (_check, max_keys() through ctypes)": lambda: (
            es._check("route_rank", dd), 1 <= nb <= lib.max_keys()),
        "max_keys() through ctypes": lambda: lib.max_keys(),
        "allocation: empty_like": lambda: torch.empty_like(dd),
        "pointers and stream": lambda: (dd.data_ptr(), out.data_ptr(),
                                        es._stream(dd)),
        "ctypes call (the launch)": lambda: lib.launch_route_rank(
            pd, po, A, n, nb, stream),
        "ops' conversion (_i32)": lambda: ops._i32(dd),
        "whole: es.route_rank": lambda: es.route_rank(dd, nb),
        "whole: ops.route_rank, the engine's": lambda: ops.route_rank(dd, nb),
        "whole: the former call path": as_before,
    }
    for what, fn in pieces.items():
        print(f"[kernels] route_rank call path: {what}: "
              f"{host_us(fn):.3f} us host", flush=True)


def two_walk_lib():
    """``event_select.cu`` built again with ``-DROUTE_KEPT=0``: its
    ``launch_route_rank`` runs the two-walk ``route_rank_kernel<0>`` at every
    n, where the library proper keeps up to 4 steps a warp in registers
    (``<1>``-``<4>``, n <= 4096)."""
    import ctypes
    from repro_torch.kernels import build
    so = build.BUILD_ROOT / "route_two_walk" / "libevent_select_two_walk.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-DROUTE_KEPT=0", "-o", str(so),
         str(build.CSRC / "event_select.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -DROUTE_KEPT=0 failed:\n{proc.stdout}")
    print(f"[build] event_select -DROUTE_KEPT=0: "
          f"{time.perf_counter() - t0:.2f} s -> {so}", flush=True)
    lib = ctypes.CDLL(str(so))
    lib.launch_route_rank.argtypes = \
        build._SIGNATURES["event_select"]["launch_route_rank"]
    return lib


def route_walks(es, dd, de, nb: int, rounds: int = 7) -> dict:
    """route_rank_kernel<4> (each warp's 4 steps kept in registers) against
    <0> (two walks, ``two_walk_lib``) at the engine's (A, 4096): both
    byte-equal to the plain version, then their device times in turns,
    ``rounds`` times, on uniform buckets (``dd``) and on the engine's input
    (``de``). Returns the medians."""
    import torch
    from repro_torch.kernels import ref
    libs = {"<4>, kept in registers": es._lib(),
            "<0>, two walks": two_walk_lib()}
    stream = es._stream(dd)
    out = {}
    for label, d in (("uniform buckets", dd), ("the engine's input", de)):
        A, n = d.shape
        want = ref.route_rank(d)
        fns = {}
        for k, lib in libs.items():
            o = torch.empty_like(d)
            args = (d.data_ptr(), o.data_ptr(), A, n, nb, stream)
            rc = lib.launch_route_rank(*args)
            if rc != 0 or not torch.equal(o, want):
                raise AssertionError(f"route_rank {k} on {label}: rc {rc}, "
                                     f"or it differs from the plain version")
            fns[k] = lambda lib=lib, args=args: lib.launch_route_rank(*args)
        times = {k: [] for k in fns}
        for _ in range(rounds):
            for k, fn in fns.items():
                times[k].append(device_ms(fn, "route_rank_kernel"))
        med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
        print(f"[kernels] route_rank ({A}x{n}, {nb} buckets, {label}) device "
              f"ms in turns: " + "; ".join(
                  f"{k} median {med[k]:.6f}, range {min(v):.6f}-"
                  f"{max(v):.6f}, rounds {[round(x, 6) for x in v]}"
                  for k, v in times.items()), flush=True)
        tag = "uniform" if dd is d else "engine"
        out[f"kept_device_ms_{tag}"] = med["<4>, kept in registers"]
        out[f"two_walk_device_ms_{tag}"] = med["<0>, two walks"]
    return out


def check_route_rank(es, ops, ref, ri) -> int:
    """route_rank against its plain version on the edges of its design: n
    from 1 to 12289 (one 32-row step a warp up to 1024, steps kept in
    registers up to 4096, two walks above), 1, 2, 9, 33 and 64 buckets
    (above 32 a lane holds two keys), uniform keys, all the sentinel
    (n_buckets - 1), one key, and the engine's compaction (k valid rows
    first, the rest the sentinel; k 0, 6 and 4096), directly and through
    ``ops``; keys outside [0, n_buckets), which leave the other rows' ranks
    as they are; the launcher's and the wrapper's refusals."""
    import torch
    A, err = 8, 0
    for n in (1, 31, 32, 33, 1000, 1024, 1025, 4096, 4097, 12289):
        for nb in (1, 2, 9, 33, 64):
            sentinel = nb - 1
            cases = {"uniform": ri(0, nb, (A, n)),
                     "sentinel": ri(sentinel, nb, (A, n)),
                     "one key": ri(nb // 2, nb // 2 + 1, (A, n))}
            for k in (0, 6, 4096):
                d = ri(sentinel, nb, (A, n))
                kk = min(k, n)
                d[:, :kk] = ri(0, max(sentinel, 1), (A, kk))
                cases[f"{k} valid first"] = d
            for d in cases.values():
                want = ref.route_rank(d)
                err = max(err, max_err(es.route_rank(d, nb), want))
                err = max(err, max_err(ops.route_rank(d, nb), want))
        print(f"[kernels] route_rank n={n} buckets 1, 2, 9, 33, 64: uniform, "
              f"all sentinel, one key, 0/6/4096 valid first (direct, ops): "
              f"equal", flush=True)
    for n, nb in ((4096, 9), (12289, 33), (1000, 64)):
        bad = ri(0, 10, (A, n)) == 0
        junk = torch.tensor([-7, -1, nb, nb + 40, 2**31 - 1],
                            dtype=torch.int32, device=bad.device)
        d = torch.where(bad, junk[ri(0, 5, (A, n)).long()], ri(0, nb, (A, n)))
        got, want = es.route_rank(d, nb), ref.route_rank(d)
        torch.cuda.synchronize()
        if not torch.equal(got[~bad], want[~bad]):
            raise AssertionError(f"route_rank n={n} n_buckets={nb}: keys out "
                                 f"of range moved the other rows' ranks")
        print(f"[kernels] route_rank n={n} buckets={nb}, "
              f"{int(bad.sum())} keys outside [0, {nb}): the other rows "
              f"equal", flush=True)
    lib = es._lib()
    d = ri(0, 9, (A, 64))
    out = torch.empty_like(d)
    for args in ((0, 64, 9), (A, 0, 9), (A, 64, 0), (A, 64, 65),
                 (A, 64, -1)):
        rc = lib.launch_route_rank(d.data_ptr(), out.data_ptr(), *args,
                                   es._stream(d))
        if rc != 1:   # cudaErrorInvalidValue
            raise AssertionError(f"launch_route_rank{args} returned {rc}, "
                                 f"want cudaErrorInvalidValue (1)")
    for nb in (0, 65):
        try:
            es.route_rank(d, nb)
        except ValueError:
            continue
        raise AssertionError(f"route_rank took n_buckets={nb}")
    print("[kernels] launch_route_rank refuses n_agents 0, n 0, n_buckets 0, "
          "65 and -1 (cudaErrorInvalidValue); the wrapper n_buckets 0 and 65 "
          "(ValueError)", flush=True)
    return err


def fused_inputs(ri, g, A, cap, density, tail, one_key=False,
                 no_table=False):
    """Random (A, cap) pools for fused_select as the engine makes them: T_INF
    time keys on unsafe slots, payloads with NaN and raw int32 patterns,
    the conflict columns pool-wide. Returns (positional inputs, kwargs)."""
    import torch
    from repro_torch.core.components import BUILTIN
    valid = ri(0, 10, (A, cap)) < 8
    safe = valid & (ri(0, 1000, (A, cap)) < int(density * 1000))
    tk = torch.where(safe, ri(0, 50, (A, cap)), 2**31 - 1)
    payload = torch.randn((A, cap, 8), generator=g).to(tk.device)
    payload[:, ::5, 3] = float("nan")
    payload.view(torch.int32)[:, ::7, 5] = ri(-2**31, 2**31 - 1,
                                              (A, len(range(0, cap, 7))))
    payload.view(torch.int32)[:, ::11, 6] = 0x7fa00001   # a signalling NaN
    table_id = ri(0, 4, (A, cap))
    res = ri(0, 8, (A, cap))
    if one_key:
        table_id, res = torch.ones_like(table_id), torch.zeros_like(res)
    if no_table:
        table_id = torch.zeros_like(table_id)
    free_tail = torch.full((A,), tail % cap, dtype=torch.int32,
                           device=tk.device)
    cols = (tk, ri(0, 1 << 20, (A, cap)), safe, ri(0, 50, (A, cap)),
            ri(-1, 10, (A, cap)), ri(0, 16, (A, cap)), ri(0, 16, (A, cap)),
            ri(0, 4, (A, cap)), payload, valid, table_id, res, free_tail)
    return cols, dict(n_kinds=BUILTIN.n_kinds, n_res=8)


def fused_equal(got, want) -> int:
    """Two ``(FusedSelect, counts)`` results: every field byte-equal (floats
    by bit pattern), rel_pos on the safe lanes, and the per-kind counts."""
    import torch
    (got, got_counts), (want, want_counts) = got, want
    max_err(got_counts, want_counts)
    safe = want.exec_safe.cpu()
    for name in want._fields:
        gv, wv = getattr(got, name).cpu(), getattr(want, name).cpu()
        if gv.shape != wv.shape or gv.dtype != wv.dtype:
            raise AssertionError(f"fused_select {name}: {gv.shape} "
                                 f"{gv.dtype} vs {wv.shape} {wv.dtype}")
        if gv.dtype == torch.float32:
            gv, wv = gv.view(torch.int32), wv.view(torch.int32)
        if name == "rel_pos":
            gv, wv = gv[safe], wv[safe]
        if not torch.equal(gv, wv):
            raise AssertionError(f"fused_select {name} differs from its "
                                 f"plain version")
    return 0


def check_fused_select(es, ref, ri, g) -> int:
    """fused_select against its plain version: the main path's shape, other
    caps and the edge cases; then the adversarial time keys and seqs of
    tests/test_torch_select.py (the other columns as ``fused_inputs`` makes
    them) and m on both sides of the radix/bitonic boundary."""
    A = 8
    cases = [  # (cap, exec_cap, safe density, free_tail, what)
        (4096, 256, 0.6, 17, "main path"), (1000, 256, 0.6, 990, "cap 1000"),
        (16384, 256, 0.6, 5, "cap 16384"), (1000, 1500, 0.6, 3,
                                            "exec_cap > cap"),
        (777, 1, 0.5, 776, "m = 1"), (4096, 256, 0.0, 9, "no safe slot"),
        (4096, 4096, 1.0, 4095, "all safe, m = cap, ring wraps"),
        (4096, 256, 0.9, 4090, "one rkey"), (4096, 256, 0.9, 1,
                                             "table_id 0")]
    for cap, xcap, dens, tail, what in cases:
        cols, kw = fused_inputs(ri, g, A, cap, dens, tail,
                                one_key=what == "one rkey",
                                no_table=what == "table_id 0")
        fused_equal(es.fused_select(*cols, xcap, **kw),
                    ref.fused_select(*cols, xcap, **kw))
        print(f"[kernels] fused_select cap={cap} exec_cap={xcap} {what}: "
              f"equal", flush=True)
    for cap, xcap, mode in [
            (4096, 256, "rand"), (4096, 256, "unsafe"), (4096, 256, "ties"),
            (4096, 256, "one_time"), (4096, 256, "neg_seq"),
            (4096, 256, "full_range"), (4096, 256, "few_keys"),
            (4096, 256, "boundary"), (4096, 1, "rand"), (4096, 1, "ties"),
            (4096, 512, "rand"), (4096, 512, "boundary"),
            (4096, 513, "rand"), (4096, 513, "few_keys"),
            (16384, 256, "neg_seq"), (1000, 256, "ties")]:
        cols, kw = fused_inputs(ri, g, A, cap, 0.6, 11)
        cols = select_pool(ri, mode, A, cap, xcap) + cols[2:]
        fused_equal(es.fused_select(*cols, xcap, **kw),
                    ref.fused_select(*cols, xcap, **kw))
        print(f"[kernels] fused_select cap={cap} exec_cap={xcap} pool "
              f"{mode}: equal", flush=True)
    return 0


def check_ring_slots(es, ref, ri) -> int:
    """ring_slots against its plain version on every row: a 4096 ring,
    4096 received rows, heads near the end of the ring."""
    import torch
    A, cap, n = 8, 4096, 4096
    heads = ri(0, cap, (A,))
    ring = torch.stack([torch.randperm(cap) for _ in range(A)]).to(
        torch.int32).to(heads.device)
    for head_lo, mode in ((0, "rand"), (cap - 8, "rand"), (cap - 3, "all"),
                          (cap - 1, "none"), (100, "all")):
        head = ri(head_lo, cap, (A,))
        want = {"rand": ri(0, 2, (A, n)) > 0,
                "all": ri(1, 2, (A, n)) > 0,
                "none": ri(0, 1, (A, n)) > 0}[mode]
        max_err(es.ring_slots(ring, head, want), ref.ring_slots(ring, head,
                                                                want))
        print(f"[kernels] ring_slots cap={cap} n={n} head>={head_lo} want "
              f"{mode}: equal", flush=True)
    return 0


def check_group_by_kind(es, ops, ref, ri) -> int:
    """group_by_kind against its plain version on the edge shapes of its
    design: m from 1 to 4096 (one 32-row step a warp up to 1024, segments of
    several steps above), 2, 9 and 33 keys, kinds below 0 and at or above
    n_kinds, every row inactive, one kind only; each with the active mask as
    bool, uint8 and int32, and through ``ops`` with the bool mask."""
    import torch
    A, err = 8, 0
    for m in (1, 31, 32, 33, 256, 1000, 1024, 1025, 4096):
        for nk in (1, 8, 32):
            for mode in ("rand", "inactive", "one_kind"):
                kd = ri(-3, nk + 3, (A, m))
                ac = ri(0, 10, (A, m)) < 6
                if mode == "inactive":
                    ac = torch.zeros_like(ac)
                elif mode == "one_kind":
                    kd, ac = torch.full_like(kd, 3), torch.ones_like(ac)
                want = ref.group_by_kind(kd, ac, nk)
                for dt in (torch.bool, torch.uint8, torch.int32):
                    err = max(err, max_err(es.group_by_kind(kd, ac.to(dt), nk),
                                           want))
                err = max(err, max_err(ops.group_by_kind(kd, ac, nk), want))
            print(f"[kernels] group_by_kind m={m} n_kinds={nk} rand, all "
                  f"inactive, one kind (bool, uint8, int32 masks; ops bool): "
                  f"equal", flush=True)
    return err


def check_ring_edges(es, ops, ref, ri) -> int:
    """ring_slots against its plain version on the edges of its design: n
    from 1 to 12289 (one to four tiles of 4,096 rows), the mask starting 0
    to 3 bytes into a word (a view of a larger allocation: read in aligned
    words, byte loads at the edges, as the wrapper documents), heads near
    the ring's end, negative, and near 2^31 - 1 (where head + rank steps over
    the int32 range; over a 3001 ring that moves the floor modulo), want
    all, none and random; through ``ops`` too."""
    import torch
    A, err = 8, 0
    i32_max = 2**31 - 1
    dev = ri(0, 1, (1,)).device
    for cap in (4096, 3001):
        ring = torch.stack([torch.randperm(cap) for _ in range(A)]).to(
            torch.int32).to(dev)
        for n in (1, 3, 4095, 4096, 4097, 12289):
            for head_lo, head_hi, what in ((cap - 3, cap, "near the end"),
                                           (-9000, 0, "negative"),
                                           (i32_max - n, i32_max,
                                            "near 2^31 - 1")):
                head = ri(head_lo, head_hi, (A,))
                for mode in ("all", "none", "rand"):
                    w = {"all": ri(1, 2, (A, n)), "none": ri(0, 1, (A, n)),
                         "rand": ri(0, 2, (A, n))}[mode] > 0
                    want = ref.ring_slots(ring, head, w)
                    for lead in range(4):
                        buf = torch.zeros(A * n + lead, dtype=torch.bool,
                                          device=dev)
                        wv = buf[lead:].view(A, n)
                        wv.copy_(w)
                        err = max(err, max_err(es.ring_slots(ring, head, wv),
                                               want))
                    err = max(err, max_err(ops.ring_slots(ring, head, w),
                                           want))
            print(f"[kernels] ring_slots cap={cap} n={n} heads near the end, "
                  f"negative, near 2^31 - 1; want all, none, rand; mask 0-3 B "
                  f"off a word; ops: equal", flush=True)
    return err


def maxmin_inputs(g, B, F, L, edge=None):
    """Seeded (inc, bw, active) on the card for B lanes of F flows over L
    links: one- to three-hop routes, bandwidths of the t0t1 sweep (0.0 a
    starved link), 70% of flows active; or an edge case: "idle" (no active
    flow), "no_bw" (every link 0), "neg_bw" (some links below 0), "repeat"
    (routes that repeat a hop)."""
    import torch
    from repro_torch.core import network as net
    links = torch.randint(-1, L, (B, F, 3), generator=g, dtype=torch.int32)
    links[..., 0] = torch.randint(0, L, (B, F), generator=g,
                                  dtype=torch.int32)
    sweep = torch.tensor([8.0, 2.0, 0.5, 0.125, 0.2, 0.0, 1.3])
    bw = sweep[torch.randint(0, len(sweep), (B, L), generator=g)]
    active = torch.rand((B, F), generator=g) < 0.7
    if edge == "idle":
        active[:] = False
    elif edge == "no_bw":
        bw[:] = 0.0
    elif edge == "neg_bw":
        bw = torch.where(torch.rand((B, L), generator=g) < 0.3, -1.5, bw)
    elif edge == "repeat":
        links[..., 1] = links[..., 0]
        links[..., 2] = links[..., 0]
    dev = torch.device("cuda")
    return (net.incidence(links.to(dev), L), bw.to(dev).contiguous(),
            active.to(dev).contiguous())


def maxmin_rounds(inc, bw, active) -> int:
    """Rounds the kernel runs over all lanes: each lane stops after its
    first round that freezes no flow (at most L)."""
    import torch
    from repro_torch.kernels import ref
    running = torch.ones(active.shape[0], dtype=torch.bool,
                         device=active.device)
    total = 0
    for _rate, newly in ref._fill_rounds(inc, bw, active):
        total += int(running.sum())
        running &= newly.any(1)
    return total


def plain_stopped(inc, bw, act):
    """``ref.maxmin_rates`` stopped after its first round that freezes no
    flow, as the kernel stops: every later round leaves the rates and the
    frozen flows as they are, so the bits are those of all L rounds, at a
    fraction of the plain version's L rounds of small ops."""
    import torch
    from repro_torch.kernels import ref
    rate = torch.zeros(act.shape, dtype=torch.float32, device=act.device)
    for rate, newly in ref._fill_rounds(inc, bw, act):
        if not bool(newly.any()):
            break
    return torch.where(act, rate, 0.0)


def maxmin_kernel_name(F: int, L: int) -> str:
    """The kernel the launcher picks for (F, L): a warp per lane up to 32
    flows and 32 links."""
    return "maxmin_warp_kernel" if F <= 32 and L <= 32 else "maxmin_kernel"


def phase_maxmin(g) -> dict:
    """The max-min water-fill kernels against their plain version, bit for
    bit, at the main paths' shapes, on both sides of the dispatch rule and
    at edge cases, each launch counted by the kernel that ran it; then
    timed, and the wrapper's host time taken apart."""
    import torch
    from repro_torch.kernels import bandwidth_share as bs
    from repro_torch.kernels import ref

    def check(B, F, L, edge=None, quiet=False, stopped=False):
        inc, bw, act = maxmin_inputs(g, B, F, L, edge)
        order = ref.flow_order(F, L, B)
        bs.reset_launches()
        got = bs.maxmin_rates(inc, bw, act, order)
        ran = {k: n for k, n in bs.KERNELS.items() if n}
        if ran != {maxmin_kernel_name(F, L): 1}:
            raise AssertionError(f"maxmin_rates {(B, F, L)} ran {ran}")
        want = (plain_stopped if stopped else ref.maxmin_rates)(inc, bw, act)
        max_err(got.view(torch.int32), want.view(torch.int32))
        if quiet:
            return inc, bw, act
        print(f"[kernels] maxmin_rates B={B} F={F} L={L} head={order.head}"
              f" chains={order.chains} tail_lanes={order.tail_lanes}"
              f" trailing={order.trailing}"
              f"{' ' + edge if edge else ''} ({next(iter(ran))}): equal",
              flush=True)
        return inc, bw, act

    # tiered_grid's (32, 4) at 2048, 8 and 1 lanes, the warp kernel's edges
    # (32 flows or links, one flow, one link) and the block kernel's side
    # (33 flows; the 64-pod workload's (128, 64))
    # (and the lane past one block's shared memory, the incidence in the
    # global workspace: 512 flows over 256 links, and 2 lanes of 300 x 200)
    cases = [(2048, 32, 4), (8, 32, 4), (1, 32, 4), (64, 32, 32),
             (64, 1, 32), (64, 32, 1), (64, 33, 4), (64, 32, 33),
             (256, 128, 64), (1, 128, 64), (1, 60, 8), (1, 1, 1), (3, 1, 4),
             (1, 512, 256), (2, 300, 200), (1, 513, 8), (1, 60, 257)]
    # both ends of every tabled range (F = 43-512, L = 1-256), one line a
    # flow count from 129 on (the orders repeat every 32 flows), against
    # the plain version stopped where the kernel stops
    for B, F, L in cases:
        check(B, F, L)
    t0 = time.perf_counter()
    n_ends = 0
    for F, ranges in sorted(ref._UNBATCHED_ORDER.items()):
        ends = sorted({L for lo, hi, _ in ranges for L in (lo, hi)})
        n_ends += len(ends)
        for L in ends:
            check(1, F, L, quiet=F > 128, stopped=True)
        if F > 128:
            print(f"[kernels] maxmin_rates B=1 F={F} L={ends}: equal",
                  flush=True)
    print(f"[time] 3 maxmin: every tabled range end ({n_ends}): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for edge in ("idle", "no_bw", "neg_bw", "repeat"):
        check(64, 32, 4, edge)
        check(1, 128, 64, edge)

    out = {}
    # the JSON row: tiered_grid's batched evaluation (8 agents x 256 lanes)
    for B, F, L in [(2048, 32, 4), (8, 32, 4), (256, 128, 64), (1, 128, 64)]:
        inc, bw, act = maxmin_inputs(g, B, F, L)
        order = ref.flow_order(F, L, B)
        big = F * L >= 4096
        ms = cuda_ms(lambda: bs.maxmin_rates(inc, bw, act, order))
        kernel = maxmin_kernel_name(F, L)
        dev_ms = device_ms(lambda: bs.maxmin_rates(inc, bw, act, order),
                           kernel)
        plain_ms = cuda_ms(lambda: ref.maxmin_rates(inc, bw, act),
                           iters=10 if big else 200)
        # inc, bw, active read once, the rates written once; per round two
        # (F x L) passes of a multiply and an add, over the rounds these
        # inputs need
        bms, by = bound(B * (F * L * 4 + L * 4 + F + F * 4),
                        4 * F * L * maxmin_rounds(inc, bw, act),
                        FP32_OPS_PER_S)
        print(f"[kernels] maxmin_rates B={B} F={F} L={L} ({kernel}): "
              f"kernel {ms:.6f} ms (device {dev_ms:.6f} ms), plain "
              f"{plain_ms:.6f} ms, library None ms, bound {bms:.9f} ms "
              f"({by})", flush=True)
        if not out:
            out = dict(max_abs_err=0, ms=ms, device_ms=dev_ms,
                       plain_ms=plain_ms, library_ms=None, bound_ms=bms,
                       bound_by=by)
            maxmin_call(bs, inc, bw, act)
    return out


def maxmin_call(bs, inc, bw, act) -> None:
    """Where a ``maxmin_rates`` call's host time goes at tiered_grid's
    batched shape, piece by piece (the mean ``time.perf_counter`` of each
    piece alone), beside the whole call and the engine's call through
    ``ops``."""
    import ctypes
    import torch
    from repro_torch.kernels import build, ops, ref
    B, F, L = inc.shape
    order = ref.flow_order(F, L, B)
    lib = build.library("bandwidth_share")
    out = torch.empty((B, F), dtype=torch.float32, device=inc.device)
    ptrs = (inc.data_ptr(), bw.data_ptr(), act.data_ptr(), out.data_ptr())
    stream = torch._C._cuda_getCurrentRawStream(inc.get_device())
    def as_before():
        """The call as the wrapper made it before its order check was
        cached: the order and shared-memory check each call (three ctypes
        calls) and a torch.cuda.Stream."""
        for name, x, dt, shape in (("inc", inc, torch.float32, (B, F, L)),
                                   ("bw", bw, torch.float32, (B, L)),
                                   ("active", act, torch.bool, (B, F))):
            bs._check(name, x, dt, shape)
        if lib.maxmin_smem_bytes(F, L) > lib.maxmin_max_smem():
            raise AssertionError("maxmin_rates: shared memory")
        words = bs._pack_order(order, F, lib.maxmin_max_order_blocks())
        packed = (ctypes.c_ulonglong * len(words))(*words)
        o = torch.empty((B, F), dtype=torch.float32, device=inc.device)
        return lib.launch_maxmin_rates(
            inc.data_ptr(), bw.data_ptr(), act.data_ptr(), o.data_ptr(),
            None, B, F, L, order.head, packed, order.chains,
            order.tail_lanes, order.trailing,
            torch.cuda.current_stream().cuda_stream)

    pieces = {
        "checks (3 tensors)": lambda: (bs._check("inc", inc, torch.float32,
                                                 (B, F, L)),
                                       bs._check("bw", bw, torch.float32,
                                                 (B, L)),
                                       bs._check("active", act, torch.bool,
                                                 (B, F))),
        "plan (cached order check)": lambda: bs._plan(F, L, order),
        "order check as before (3 ctypes calls)": lambda: (
            lib.maxmin_smem_bytes(F, L) > lib.maxmin_max_smem(),
            bs._pack_order(order, F, lib.maxmin_max_order_blocks())),
        "allocation": lambda: torch.empty((B, F), dtype=torch.float32,
                                          device=inc.device),
        "stream (raw handle)":
            lambda: torch._C._cuda_getCurrentRawStream(inc.get_device()),
        "stream (torch.cuda.current_stream, as before)":
            lambda: torch.cuda.current_stream().cuda_stream,
        "data_ptr x4": lambda: (inc.data_ptr(), bw.data_ptr(),
                                act.data_ptr(), out.data_ptr()),
        "ctypes call (the launch)": lambda: lib.launch_maxmin_rates(
            *ptrs, None, B, F, L, 0, None, 1, 1, 0, stream),
        "whole: bs.maxmin_rates": lambda: bs.maxmin_rates(inc, bw, act,
                                                          order),
        "whole: the call as before": as_before,
        "whole: ops.maxmin_rates, the engine's": lambda: ops.maxmin_rates(
            inc, bw, act),
    }
    for what, fn in pieces.items():
        print(f"[kernels] maxmin_rates call path (2048, 32, 4): {what}: "
              f"{host_us(fn):.3f} us host", flush=True)


# ------------------------------------------- CPU references, in the background
def _cpu_built(name: str):
    """The scenarios whose CPU runs and oracles run in worker processes,
    rebuilt there from their names."""
    from repro_torch.core import components as comps
    from repro_torch.core import workload as wl
    from repro_torch.scenarios import cache, failures
    if name == "tiered":
        return tiered_grid(comps).build(**tiered_build_kw())
    if name == "workload":
        return wl.training_scenario(workload_cell())
    if name == "cache":
        return cache.build_churn_scenario(**CACHE_KW)[0]
    if name == "failures":
        return failures.build_failure_scenario(**FAIL_KW)[0]
    if name == "cut":
        return failures.build_failure_scenario(**ENS_CUT)[0]
    if name == "grid64":
        b, kw = grid_64_flows(comps)
        return b.build(**kw)
    raise ValueError(name)


def _oracle_np(built, **kw) -> dict:
    from repro_torch.core import run_sequential
    ow, oc, trace = run_sequential(*built, **kw)
    return dict(world={f: getattr(ow, f).numpy() for f in ow._fields},
                counters=oc.numpy(), trace=trace)


def _cpu_job(job: str):
    """One reference computation on the CPU, in a worker process (one torch
    thread): the scenario rebuilt from its name, the result as numpy."""
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    import contextlib
    import io
    import torch
    torch.set_num_threads(1)
    from repro_torch.convert import state_to_numpy
    from repro_torch.core import Engine
    from repro_torch.core.engine import seed_rng_fields
    t0 = time.perf_counter()
    kind, _, what = job.partition(" ")
    if what == "oracle" and kind == "ensemble":
        built = _cpu_built("failures")
        world = built[0]._replace(fp_rng=seed_rng_fields(
            Engine(*built, device="cpu").init_state(),
            torch.tensor(ENS_SOLO[-1], dtype=torch.int32)).world.fp_rng[0])
        out = _oracle_np((world, *built[1:]), max_events=2_000_000)
    elif what == "oracle":
        out = _oracle_np(_cpu_built(kind), max_events=2_000_000)
    elif kind == "workload":
        from repro_torch.core import workload as wl
        st = Engine(*_cpu_built(kind), device="cpu").run_local(
            max_windows=200_000)
        out = (state_to_numpy(st), wl.summarize(workload_cell(), st))
    elif kind == "failures":
        from repro_torch.core.policy import ExecPolicy
        built = _cpu_built(kind)
        eng = Engine(*built, trace_cap=65536, device="cpu")
        ada = eng.run_adaptive(max_windows=200_000,
                               policy=ExecPolicy(ladder=FAIL_LADDER))
        out = (state_to_numpy(Engine(*built, trace_cap=65536,
                                     device="cpu").run_local()),
               state_to_numpy(ada), eng.adaptive_rungs)
    elif kind == "cut":
        out = state_to_numpy(Engine(*_cpu_built(kind), trace_cap=ENS_TRACE,
                                    device="cpu").run_ensemble(ENS_CUT_SEEDS))
    elif kind == "grid64":
        out = state_to_numpy(Engine(*_cpu_built(kind), trace_cap=1024,
                                    device="cpu").run_distributed(
            ["cpu"] * 2))
    elif kind == "zoo":
        out = zoo_run(what, "cpu")
    elif kind == "train":
        out = train_run(what, "cpu")
    elif kind == "roofline":
        out = roofline_record(*what.split())
    elif kind == "cli":
        from repro_torch.launch import simulate
        with contextlib.redirect_stdout(io.StringIO()):
            out = simulate.main(what.split() + ["--device", "cpu"])
    else:
        out = state_to_numpy(Engine(*_cpu_built(kind), trace_cap=65536,
                                    device="cpu").run_local())
    return out, time.perf_counter() - t0


CPU_JOBS = ("tiered cpu", "tiered oracle", "workload cpu", "cache cpu",
            "cache oracle", "failures cpu", "failures oracle",
            "ensemble oracle", "cut cpu", "cli ensemble",
            "cli run ensemble_farm", "grid64 cpu",
            f"cli distributed --devices {DIST_D}",
            *(f"cli t0t1 {' '.join(flags)}" for flags in T0T1_RUNS.values()),
            "zoo hymba-1.5b", "zoo rwkv6-7b", "zoo moonshot-v1-16b-a3b",
            "zoo whisper-large-v3", "zoo qwen2-vl-72b",
            *(f"train {arch}" for arch in TRAIN_FAMILIES),
            *(f"roofline {arch} train" for arch, _ in TRAIN_FULL),
            f"roofline {TRI_ARCH} tri",
            *(f"roofline {arch} prefill" for arch in ROOFLINE_ADMITS))


class Background:
    """The CPU reference runs and oracles of phases 4-4g, started together
    in worker processes at the start, so the card's phases do not wait for
    them; ``get`` returns a job's result (raising what the job raised) and
    prints how long it took and how long the card's side waited."""

    def __init__(self, workers: int = 4):
        import concurrent.futures
        import multiprocessing
        self.pool = concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"))
        self.jobs = {name: self.pool.submit(_cpu_job, name)
                     for name in CPU_JOBS}

    def get(self, name: str):
        t0 = time.perf_counter()
        out, took = self.jobs[name].result()
        print(f"[background] {name}: {took:.1f} s in a worker, waited "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        return out

    def close(self) -> None:
        self.pool.shutdown(wait=True, cancel_futures=True)


# --------------------------------------------------------------- phase 4c
def workload_cell():
    """The 64-pod cell of phase 4c."""
    from repro_torch.core import workload as wl
    return wl.CellModel(n_pods=64, t_compute_s=0.05, dcn_bytes_per_pod=2e9,
                        n_steps=1)


def phase_workload(card: str, bg: Background) -> dict:
    """The workload bridge at full width: a 64-pod cell (128 flow slots
    over 64 WAN links, one agent) on the card and on the CPU; then the
    ``simulate workload`` entry point on both devices."""
    import tempfile
    import torch
    from repro_torch.core import Engine
    from repro_torch.core import monitoring as mon
    from repro_torch.core import workload as wl
    from repro_torch.launch import simulate

    cell = workload_cell()
    scen = wl.training_scenario(cell)
    spec = scen[3]
    print(f"[workload] 64 pods: {spec.n_lp} LPs, flow table "
          f"{scen[0].flow_active.shape[1]} x link table "
          f"{scen[0].link_bw.shape[1]}, exec_cap {spec.exec_cap}", flush=True)
    eng = Engine(*scen, device="cuda")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    st = eng.run_local(max_windows=200_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ran = launches()
    got = wl.summarize(cell, st)
    c = st.counters.sum(0).tolist()
    windows = got["windows"]
    print(f"[workload] 64 pods cuda: {got}; wall {wall:.3f} s, "
          f"{c[mon.C_BATCH_FALLBACK] / windows:.2f} fallback rows/window, "
          f"launches {ran} ({card})", flush=True)
    if ran["maxmin_rates"] == 0:
        raise AssertionError("maxmin_rates never launched at 64 pods")
    maxmin_routes("64 pods", ran, "maxmin_kernel")
    st_cpu, want = bg.get("workload cpu")
    state_equal(st, st_cpu)
    if got != want:
        raise AssertionError(f"64 pods: cuda {got} != cpu {want}")
    print("[workload] 64 pods: cuda state == cpu state, same result",
          flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        rec = {"status": "ok", "arch": "dense", "shape": "train_4k",
               "mesh": "2x4", "roofline": {
                   "t_compute_s": 0.031, "t_memory_s": 0.012,
                   "coll_by_kind": {"all-reduce": 1.5e9}}}
        with open(os.path.join(tmp, "dense.json"), "w") as f:
            json.dump(rec, f)
        lines = {d: simulate.main(["workload", "--results", tmp, "--device",
                                   d]) for d in ("cuda", "cpu")}
    if lines["cuda"] != lines["cpu"] or len(lines["cuda"]) != 1:
        raise AssertionError(f"simulate workload: {lines}")
    print("[simulate] workload --device cuda == --device cpu", flush=True)
    return dict(launches=ran, wall=wall, windows=windows,
                fallback_rows=c[mon.C_BATCH_FALLBACK])


# --------------------------------------------------------------- phase 4
def state_equal(a, b, parts=None) -> None:
    """Byte equality of two port states (floats by bit pattern), or of the
    named ``parts`` of them; either may be ``state_to_numpy``'s dict."""
    from repro_torch.convert import state_to_numpy
    sa, sb = (x if isinstance(x, dict) else state_to_numpy(x)
              for x in (a, b))
    if parts is not None:
        sa = {k: sa[k] for k in parts}

    def walk(x, y, path):
        if isinstance(x, dict):
            for k in x:
                walk(x[k], y[k], f"{path}.{k}")
            return
        if x.shape != y.shape or x.dtype != y.dtype or x.tobytes() != y.tobytes():
            raise AssertionError(f"state differs at {path}")

    walk(sa, sb, "state")


def run_tiered(card: str, fused: bool):
    """The tiered Grid on the card with the launch counts read around the
    run; raises on a drop. Returns (state, launches, numbers)."""
    import torch
    from repro_torch.core import components as comps
    from repro_torch.core import Engine
    from repro_torch.core import monitoring as mon

    world, own, init_ev, spec = tiered_grid(comps).build(
        **tiered_build_kw(), fused_select=fused)
    label = "fused" if fused else "stitched"
    print(f"[tiered_grid] {label}: {spec.n_lp} LPs, {spec.n_agents} agents, "
          f"pool_cap {spec.pool_cap}, exec_cap {spec.exec_cap}, emit_cap "
          f"{spec.emit_cap}, route_cap {spec.route_cap}", flush=True)
    eng = Engine(world, own, init_ev, spec, trace_cap=65536, device="cuda")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    st = eng.run_local()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ran = launches()
    c = st.counters.sum(0).cpu()
    windows, events = int(st.windows[0]), int(c[mon.C_EVENTS])
    print(f"[tiered_grid] {label} cuda: host reads/window "
          f"{eng.host_reads / windows:.4f}", flush=True)
    print(f"[tiered_grid] {label} cuda: windows={windows} events={events} "
          f"wall={wall:.3f} s events/s={events / wall:.1f} "
          f"windows/s={windows / wall:.2f} launches={ran} "
          f"({card})", flush=True)
    for i in mon.DROP_COUNTERS + (mon.C_TRACE_DROP,):
        if int(c[i]) != 0:
            raise AssertionError(f"counter {mon.BUILTIN_COUNTERS[i][0]} = "
                                 f"{int(c[i])}")
    if ran["maxmin_rates"] == 0:
        raise AssertionError(f"maxmin_rates never launched on the {label} "
                             f"path")
    maxmin_routes(label, ran, "maxmin_warp_kernel")
    return st, ran, dict(windows=windows, events=events, wall=wall,
                         host_reads=eng.host_reads)


def maxmin_routes(label: str, ran: dict, kernel: str) -> dict:
    """The run's ``maxmin_rates`` launches by the kernel that ran them:
    all of them through ``kernel``."""
    from repro_torch.kernels import bandwidth_share as bs
    routes = dict(bs.KERNELS)
    if routes[kernel] != ran["maxmin_rates"] or sum(routes.values()) != \
            ran["maxmin_rates"]:
        raise AssertionError(f"{label}: maxmin_rates launches {routes}, "
                             f"want all {ran['maxmin_rates']} in {kernel}")
    print(f"[maxmin] {label}: all {ran['maxmin_rates']} maxmin_rates "
          f"launches ran {kernel} ({routes})", flush=True)
    return routes


def phase_fused_path(card: str, stitched) -> dict:
    """Phase 4b: the fused front end at full size, against the stitched
    card run and the oracle."""
    from repro_torch.core import merged_engine_trace
    st, ran, nums = run_tiered(card, fused=True)
    for k in ("fused_select", "ring_slots", "trace_rank", "route_rank"):
        if ran[k] == 0:
            raise AssertionError(f"{k} never launched on the fused path")
    for k in ("select_events", "group_by_kind"):
        if ran[k] != 0:
            raise AssertionError(f"{k} launched on the fused path")
    if ran["ring_slots"] != nums["windows"]:
        raise AssertionError(f"ring_slots launched {ran['ring_slots']} times "
                             f"in {nums['windows']} windows")
    state_equal(st, stitched["state"])
    print("[tiered_grid] fused cuda state == stitched cuda state (trace, "
          "counters, world, pool, ring cursors)", flush=True)
    got = merged_engine_trace(st.trace, st.trace_n)
    if sorted(got) != stitched["oracle"]:
        raise AssertionError("fused merged trace != sequential oracle")
    print("[tiered_grid] fused merged trace == sequential oracle", flush=True)
    return dict(launches=ran, **nums)


def phase_main_path(card: str, bg: Background) -> dict:
    from repro_torch.core import merged_engine_trace

    st, ran, nums = run_tiered(card, fused=False)
    missing = [k for k in ("select_events", "group_by_kind", "trace_rank",
                           "route_rank") if ran[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    if ran["group_by_kind"] != nums["windows"]:
        raise AssertionError(f"group_by_kind launched {ran['group_by_kind']}"
                             f" times in {nums['windows']} windows")

    state_equal(st, bg.get("tiered cpu"))
    print("[tiered_grid] cuda state == cpu state (trace, counters, world, "
          "pool, ring cursors)", flush=True)

    want = bg.get("tiered oracle")["trace"]
    got = merged_engine_trace(st.trace, st.trace_n)
    # The reference's child_seq ids collide across generators here (an
    # initial seq s equals child_seq(p, k) when s == 4p + k + 1), so events
    # of different LPs can share (time, seq) and the (time, seq) merge order
    # of such ties is arbitrary. Compare in full-row order.
    if sorted(got) != sorted(want):
        raise AssertionError(f"merged engine trace ({len(got)} rows) != "
                             f"sequential oracle ({len(want)} rows)")
    ties = len(want) - len({(r[0], r[1]) for r in want})
    print(f"[tiered_grid] merged trace == sequential oracle ({len(want)} "
          f"events, {ties} rows share (time, seq) with another)", flush=True)
    return dict(launches=ran, state=st, oracle=sorted(want), **nums)


def phase_profile(card: str, fused: bool, start: int = 150,
                  n: int = 20) -> None:
    """Where a window's time goes on a path: ``n`` windows of the tiered
    Grid from window ``start`` on, first unprofiled, then under
    torch.profiler (device busy share, kernels per window, host time of the
    engine's labelled steps)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import components as comps
    from repro_torch.core import Engine

    world, own, init_ev, spec = tiered_grid(comps).build(
        **tiered_build_kw(), fused_select=fused)
    eng = Engine(world, own, init_ev, spec, trace_cap=65536, device="cuda")
    st = eng.run_local(max_windows=start)
    tag = "[profile fused]" if fused else "[profile stitched]"

    def steps(st):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            st = eng.step_local(st)
        torch.cuda.synchronize()
        return st, (time.perf_counter() - t0) / n * 1e3

    st, plain_ms = steps(st)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        st, prof_ms = steps(st)
    kern = device_ops(prof)
    if not kern:
        raise AssertionError(f"{tag}: the profile holds no device op")
    busy_ms = sum(e.duration_ns() for e in kern) / 1e6 / n
    print(f"{tag} windows {start}..{start + 2 * n}: {plain_ms:.3f} "
          f"ms/window unprofiled, {prof_ms:.3f} ms/window profiled; "
          f"{len(kern) / n:.1f} device ops/window, device busy "
          f"{busy_ms:.3f} ms/window = {busy_ms / prof_ms:.4f} of the "
          f"profiled wall ({card})", flush=True)
    for key, (ns, calls) in sorted(host_spans(prof).items()):
        print(f"{tag} {key}: host {ns / 1e6 / n:.3f} ms/window, "
              f"{calls / n:.2f} calls/window", flush=True)


def phase_entry_point(bg: Background) -> dict:
    """Phase 5: ``simulate t0t1`` on the card against ``--device cpu`` (run
    in ``Background``)."""
    from repro_torch.launch import simulate
    ran, lines = {}, {}
    for name, flags in T0T1_RUNS.items():
        reset_launches()
        t0 = time.perf_counter()
        got = simulate.main(["t0t1", *flags, "--device", "cuda"])
        t_card = time.perf_counter() - t0
        ran[name] = launches()
        want = bg.get(f"cli t0t1 {' '.join(flags)}")
        if got != want:
            raise AssertionError(f"simulate t0t1 {' '.join(flags)}: cuda "
                                 f"{got} != cpu {want}")
        if name.startswith("4 ") and got != lines["4"]:
            raise AssertionError(f"simulate t0t1 {' '.join(flags)}: {got} "
                                 f"!= the stitched run {lines['4']}")
        lines[name] = got
        print(f"[simulate] t0t1 {' '.join(flags)}: cuda == cpu"
              f"{' == stitched' if name.startswith('4 ') else ''} "
              f"(cuda {t_card:.1f} s, launches {ran[name]})", flush=True)
    if ran["4"]["route_rank"] == 0:
        raise AssertionError("route_rank never launched with 4 agents")
    for name, counts in ran.items():
        if counts["maxmin_rates"] == 0:
            raise AssertionError(f"maxmin_rates never launched in t0t1 "
                                 f"run {name!r}")
    for k in ("fused_select", "ring_slots"):
        if ran["4 fused"][k] == 0:
            raise AssertionError(f"{k} never launched under --fused-select")
    return ran


# --------------------------------------------------------------- phase 4e
# The two extension models at widths their users would call real. The
# replica cache: 1,024 caches of 8 ways, 8 keys, so the first 8 rounds miss
# and the rest hit; the depth cut to 10 rounds. The failure/repair process:
# 64 farms of 16 CPUs, 2 processes a farm (same-row collisions through the
# fallback), bursts of 3, a JOB_SUBMIT generator a farm; the depth cut to
# 6 bursts a process and 32 jobs a farm. 8 agents each; pool_cap keeps
# every drop counter at 0.
CACHE_KW = dict(n_caches=1024, cache_ways=8, n_keys=8, n_rounds=10,
                n_agents=8, pool_cap=4096)
FAIL_KW = dict(n_farms=64, n_cpu=16, procs_per_farm=2, burst=3, n_bursts=6,
               jobs_per_farm=32, n_agents=8, pool_cap=1024)
FAIL_LADDER = (16, 64, 256)
STITCHED_HOOKS = ("select_events", "group_by_kind", "trace_rank",
                  "route_rank")
FUSED_HOOKS = ("fused_select", "ring_slots", "trace_rank", "route_rank")


def device_ops(prof) -> list:
    """The device's own ops in a profile (kernels, copies, sets), read from
    the raw trace (quicker than ``prof.events()``). The profiler also mirrors
    each ``record_function`` range on the device's timeline (a user
    annotation spanning the range's kernels): those are spans, not work,
    and are left out."""
    from torch.autograd import DeviceType
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not e.is_user_annotation()]


def host_spans(prof) -> dict:
    """Host ns and calls of each engine step's label (``window.*``,
    ``execute.*``) in a profile, read from the raw trace: the sum of the
    ranges' durations, what ``key_averages()`` gives as their CPU total,
    without its parse of every recorded op."""
    from torch.autograd import DeviceType
    spans: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name().startswith(
                ("window.", "execute.")):
            ns, calls = spans.get(e.name(), (0, 0))
            spans[e.name()] = (ns + e.duration_ns(), calls + 1)
    return spans


def profile_windows(eng, st, n: int = 10):
    """``n`` windows from state ``st`` under torch.profiler: ms a window,
    device ops a window and the device's busy share of the wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            st = eng.step_local(st)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / n * 1e3
    kern = device_ops(prof)
    if not kern:
        raise AssertionError("the profile holds no device op")
    busy = sum(e.duration_ns() for e in kern) / 1e6 / n
    return ms, len(kern) / n, busy / ms


def run_model(label: str, built, card: str, fused: bool = False,
              policy=None):
    """One run of a built extension model on the card through the normal
    entry point (``run_local``, or ``run_adaptive`` under ``policy``), the
    launch counts set to 0 just before and read just after; raises on a
    drop or a hook kernel that never launched. Returns (engine, state,
    launches, numbers)."""
    import dataclasses
    import torch
    from repro_torch.core import Engine
    from repro_torch.core import monitoring as mon

    spec = dataclasses.replace(built[3], fused_select=fused)
    eng = Engine(*built[:3], spec, trace_cap=65536, device="cuda")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    st = (eng.run_local() if policy is None
          else eng.run_adaptive(max_windows=200_000, policy=policy))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ran = launches()
    c = st.counters.sum(0).cpu()
    windows, events = int(st.windows[0]), int(c[mon.C_EVENTS])
    for i in mon.DROP_COUNTERS + (mon.C_TRACE_DROP,):
        if int(c[i]) != 0:
            raise AssertionError(f"{label}: counter "
                                 f"{mon.BUILTIN_COUNTERS[i][0]} = {int(c[i])}")
    hooks = FUSED_HOOKS if fused else STITCHED_HOOKS
    missing = [k for k in hooks if ran[k] == 0]
    if missing:
        raise AssertionError(f"{label}: never launched {missing}")
    if fused and (ran["select_events"] or ran["group_by_kind"]):
        raise AssertionError(f"{label}: the stitched hooks launched {ran}")
    print(f"[scenarios] {label} cuda: windows={windows} events={events} "
          f"wall={wall:.3f} s events/s={events / wall:.1f} "
          f"fallback rows/window={int(c[mon.C_BATCH_FALLBACK]) / windows:.2f}"
          f" fallback steps/window={eng.fallback_steps / windows:.2f} "
          f"host reads/window={eng.host_reads / windows:.4f}"
          f" launches={ran} ({card})", flush=True)
    return eng, st, ran, dict(windows=windows, events=events, wall=wall,
                              fallback_steps=eng.fallback_steps,
                              host_reads=eng.host_reads)


def oracle_equal(label: str, built, runs: dict, oracle: dict) -> None:
    """Every run's merged trace equals the oracle's (``_oracle_np``) in
    full-row order, and its model counters and component tables the
    oracle's."""
    import numpy as np
    from repro_torch.core import merged_engine_trace
    from repro_torch.core import monitoring as mon
    from repro_torch.core.registry import registry_of
    want, oc = oracle["trace"], oracle["counters"]
    reg = registry_of(built[0])
    for name, st in runs.items():
        got = merged_engine_trace(st.trace, st.trace_n)
        if sorted(got) != sorted(want):
            raise AssertionError(f"{label} {name}: merged trace != oracle")
        c = st.counters.sum(0).cpu().numpy()
        if not np.array_equal(c[mon.N_COUNTERS:], oc[mon.N_COUNTERS:]):
            raise AssertionError(f"{label} {name}: model counters "
                                 f"{c[mon.N_COUNTERS:]} != oracle's "
                                 f"{oc[mon.N_COUNTERS:]}")
        for f in reg.delta_schema:
            a = getattr(st.world, f)[0].cpu().numpy()
            if a.tobytes() != oracle["world"][f].tobytes():
                raise AssertionError(f"{label} {name}: world.{f} != oracle")
    ties = len(want) - len({(r[0], r[1]) for r in want})
    counts = {n: int(oc[i]) for n, i in reg.counters.items()
              if i >= mon.N_COUNTERS}
    print(f"[scenarios] {label}: {', '.join(runs)} == oracle in full-row "
          f"order ({len(want)} events, {ties} rows share (time, seq); "
          f"{counts})", flush=True)


def phase_scenarios(card: str, bg: Background) -> dict:
    """The replica-cache and failure/repair models on the card: stitched,
    fused and adaptive runs against the CPU run and the oracle; then the
    failure model's log replica on every unit draw and int32 payload bit
    patterns through both front ends."""
    import torch
    from repro_torch.core.policy import ExecPolicy
    from repro_torch.scenarios import cache, failures

    out = {}
    built, _ = cache.build_churn_scenario(**CACHE_KW)
    print(f"[scenarios] cache: {CACHE_KW}, {built[3].n_lp} LPs, "
          f"{cache.CACHE_REGISTRY.n_kinds} kinds", flush=True)
    eng, st, ran, nums = run_model("cache stitched", built, card)
    ms, ops, busy = profile_windows(eng, eng.init_state())
    print(f"[scenarios] cache stitched: windows 0..10 {ms:.3f} ms/window "
          f"profiled, {ops:.1f} device ops/window, device busy {busy:.4f} "
          f"of the wall ({card})", flush=True)
    _e, st_f, ran_f, nums_f = run_model("cache fused", built, card,
                                        fused=True)
    state_equal(st_f, st)
    state_equal(st, bg.get("cache cpu"))
    print("[scenarios] cache: fused cuda == stitched cuda == stitched cpu",
          flush=True)
    oracle_equal("cache", built, {"stitched": st, "fused": st_f},
                 bg.get("cache oracle"))
    out["cache"] = dict(stitched=nums, fused=nums_f, ops_per_window=ops)

    built, _ = failures.build_failure_scenario(**FAIL_KW)
    print(f"[scenarios] failures: {FAIL_KW}, {built[3].n_lp} LPs, "
          f"{failures.FAIL_REGISTRY.n_kinds} kinds", flush=True)
    eng, st, ran, nums = run_model("failures stitched", built, card)
    ms, ops, busy = profile_windows(eng, eng.init_state())
    print(f"[scenarios] failures stitched: windows 0..10 {ms:.3f} "
          f"ms/window profiled, {ops:.1f} device ops/window, device busy "
          f"{busy:.4f} of the wall ({card})", flush=True)
    _e, st_f, ran_f, nums_f = run_model("failures fused", built, card,
                                        fused=True)
    state_equal(st_f, st)
    policy = ExecPolicy(ladder=FAIL_LADDER)
    eng_a, st_a, ran_a, nums_a = run_model("failures adaptive", built, card,
                                           policy=policy)
    cpu_st, cpu_ada, cpu_rungs = bg.get("failures cpu")
    state_equal(st, cpu_st)
    state_equal(st_a, cpu_ada)
    if tuple(cpu_rungs) != eng_a.adaptive_rungs:
        raise AssertionError("failures adaptive: the rungs differ on the cpu")
    rungs = {w: eng_a.adaptive_rungs.count(i)
             for i, w in enumerate(FAIL_LADDER)}
    print(f"[scenarios] failures: fused cuda == stitched cuda == stitched "
          f"cpu, adaptive cuda == adaptive cpu (windows by width {rungs})",
          flush=True)
    oracle_equal("failures", built, {"stitched": st, "fused": st_f,
                                     "adaptive": st_a},
                 bg.get("failures oracle"))
    out["failures"] = dict(stitched=nums, fused=nums_f, adaptive=nums_a,
                           ops_per_window=ops)
    out["failures_run"] = (built, st)

    # the log replica on every value of the unit draw, card against cpu
    k = torch.arange(1 << 22, dtype=torch.int32)
    u = (k.float() + 0.5) / float(1 << 22)
    want = failures.xla_log(u)
    got = failures.xla_log(u.cuda()).cpu()
    n_diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    lib_diff = int((torch.log(u.cuda()).cpu().view(torch.int32)
                    != want.view(torch.int32)).sum())
    if n_diff:
        raise AssertionError(f"xla_log: {n_diff} of {1 << 22} differ on the "
                             f"card")
    print(f"[scenarios] xla_log: cuda == cpu on all {1 << 22} unit draws "
          f"(torch.log on the card differs on {lib_diff})", flush=True)
    payload_bits(card)
    return out


def payload_bits(card: str) -> None:
    """An int32 payload field with 31-bit, denormal and NaN bit patterns
    through the stitched and fused engines on the card (8 agents) and the
    oracle: every bit arrives."""
    import dataclasses
    import torch
    from repro_torch.core import Engine, merged_engine_trace, run_sequential
    from repro_torch.core import tensor_util as tu
    from repro_torch.core.components import BUILTIN
    from repro_torch.core.events import MAX_EMIT, empty_batch
    from repro_torch.core.registry import (FieldSpec, PayloadSpec,
                                           ScenarioBuilderBase)

    reg = BUILTIN.extend()
    reg.component("idsink", fields=dict(
        sink_token=FieldSpec((), torch.int32, mutable=True),
        sink_n=FieldSpec((), torch.int32, mutable=True)))
    payload = PayloadSpec(("token", 0, torch.int32), "weight")
    put = reg.kind("TOKEN_PUT", table="idsink", payload=payload)

    @reg.on(put)
    def h_token_put(env, world, counters, e):
        s = tu.take(world.lp_res, e.agent, e.dst)
        delta = env.delta(world, "idsink", s,
                          sink_token=payload.get(e.payload, "token"),
                          sink_n=tu.take(world.sink_n, e.agent, s) + 1)
        return delta, counters, empty_batch((e.time.shape[0], MAX_EMIT),
                                            device=e.time.device)

    class Builder(ScenarioBuilderBase):
        _registry = reg

    tokens = [(1 << 31) - 1, 0x7F800001, 0x7FC00001, 0x7FFFFFFF, 1, 3,
              0x007FFFFF, -5, -(1 << 31), 16777217, 0]
    b = Builder()
    sinks = [b.add_idsink() for _ in tokens]
    for lp, tok in zip(sinks, tokens):
        b.add_event(time=1 + lp % 3, kind=put, src=lp, dst=lp,
                    payload=payload.pack(token=tok, weight=1.0))
    built = b.build(n_agents=8, lookahead=1, t_end=20, pool_cap=64)
    _w, _c, want = run_sequential(*built)
    for fused in (False, True):
        spec = dataclasses.replace(built[3], fused_select=fused)
        st = Engine(*built[:3], spec, trace_cap=64, device="cuda").run_local()
        got = st.world.sink_token[0].cpu().tolist()
        if got != tokens or st.world.sink_n[0].cpu().tolist() != [1] * len(
                tokens):
            raise AssertionError(f"payload bits fused={fused}: {got}")
        if merged_engine_trace(st.trace, st.trace_n) != want:
            raise AssertionError(f"payload bits fused={fused}: trace")
    bits = [hex(t & 0xFFFFFFFF) for t in tokens]
    print(f"[scenarios] int32 payload bits {bits} arrive through the "
          f"stitched and fused engines and the oracle ({card})", flush=True)


# --------------------------------------------------------------- phase 4f
# The host layer on the stitched tiered Grid of phase 4: a 512-row ring
# drained every 16 windows (and whenever a window of 256 rows could
# overrun it), metrics every 32 windows, a checkpoint every 64; a resume
# from the checkpoint of window 320 (past the ring), and a placement at
# the same checkpoint, each run on to the end (68 of the 388 windows).
# Then the CLI's crash harness on the card, resumed on the card and on the
# CPU.
RING, DRAIN_EVERY, METRICS_EVERY, CK_EVERY = 512, 16, 32, 64
RESUME_AT = MIGRATE_AT = 320
CLI_T0T1 = ["t0t1", "--agents", "4", "--bandwidths", "8.0", "--exec-cap",
            "32", "--stream-trace", "32"]


def streamed_engine(built, dev: str, ckdir: str, every: int | None = None,
                    **kw):
    """An engine with a fresh trace stream, metrics stream and timed
    checkpointer (and the hooks ``kw``); ``eng.checkpointer.save_ms`` holds
    each save's ms."""
    import torch
    from repro_torch.checkpoint import SimCheckpointer
    from repro_torch.core import Engine, MetricsStream, TraceStream

    class Timed(SimCheckpointer):
        def save_sim(self, window, state, **kw):
            if dev == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            super().save_sim(window, state, **kw)
            self.save_ms.append((time.perf_counter() - t0) * 1e3)

    ck = Timed(ckdir, every=CK_EVERY if every is None else every, keep=64)
    ck.save_ms = []
    return Engine(*built, trace_cap=RING, device=dev,
                  trace_stream=TraceStream(),
                  metrics_stream=MetricsStream(METRICS_EVERY),
                  drain_every=DRAIN_EVERY, checkpointer=ck, **kw)


def no_drop(label: str, st) -> None:
    from repro_torch.core import monitoring as mon
    c = st.counters.sum(0).cpu()
    for i in mon.DROP_COUNTERS + (mon.C_TRACE_DROP,):
        if int(c[i]) != 0:
            raise AssertionError(f"{label}: counter "
                                 f"{mon.BUILTIN_COUNTERS[i][0]} = {int(c[i])}")


def sync(dev: str) -> None:
    import torch
    if dev == "cuda":
        torch.cuda.synchronize()


def phase_streams(card: str, built, main_run: dict, ckdir: str,
                  dev: str = "cuda") -> dict:
    """The streamed run against phase 4's buffered one, then the resume."""
    import numpy as np
    from repro_torch.core import merged_engine_trace
    from repro_torch.core import monitoring as mon

    eng = streamed_engine(built, dev, ckdir)
    sync(dev)
    reset_launches()
    t0 = time.perf_counter()
    st = eng.run_local()
    sync(dev)
    wall = time.perf_counter() - t0
    ran = launches()
    ts, ms = eng.trace_stream, eng.metrics_stream
    windows = int(st.windows[0])
    events = int(st.counters[:, mon.C_EVENTS].sum())
    no_drop("streamed", st)
    if int(st.trace_n.max()) <= RING:
        raise AssertionError(f"streamed: trace_n {st.trace_n.tolist()} never "
                             f"passed the {RING}-row ring")
    base = main_run["state"]
    if ts.merged() != merged_engine_trace(base.trace, base.trace_n):
        raise AssertionError("streamed merged trace != phase 4's buffered")
    state_equal(st, base, parts=("world", "pool", "counters"))
    if ms.lines[-1]["counters"] != mon.snapshot(st.counters):
        raise AssertionError("the final metrics record != the counters")
    missing = [k for k in STITCHED_HOOKS if ran[k] == 0]
    if missing:
        raise AssertionError(f"streamed: never launched {missing}")
    base_ms = main_run["wall"] / main_run["windows"] * 1e3
    print(f"[streams] tiered_grid streamed {dev}: {windows} windows, "
          f"{events} events, trace_n {st.trace_n.tolist()} through a "
          f"{RING}-row ring, {len(ms.lines)} metrics records; "
          f"{wall / windows * 1e3:.3f} ms/window, {events / wall:.1f} "
          f"events/s (unstreamed, phase 4: {base_ms:.3f} ms/window, "
          f"{main_run['events'] / main_run['wall']:.1f} events/s); host "
          f"reads/window {eng.host_reads / windows:.4f} (unstreamed "
          f"{main_run['host_reads'] / main_run['windows']:.4f}); "
          f"{eng.drains} ring copies, {eng.drain_bytes} bytes; launches "
          f"{ran} ({card})", flush=True)
    print("[streams] streamed merged trace == phase 4's buffered trace; "
          "world, pool, counters == phase 4's card state; final metrics "
          "record == snapshot of the counters; C_TRACE_DROP 0", flush=True)
    ck = eng.checkpointer
    sizes = [os.path.getsize(os.path.join(ckdir, f"step_{s:09d}",
                                          "host_0.npz"))
             for s in ck.all_steps()]
    print(f"[streams] {len(ck.save_ms)} checkpoint saves (steps "
          f"{ck.all_steps()}): {np.mean(ck.save_ms):.3f} ms each (max "
          f"{max(ck.save_ms):.3f}), {int(np.mean(sizes))} bytes each "
          f"({card})", flush=True)

    # the checkpoint of RESUME_AT (past the ring), into a fresh engine and
    # streams
    step = RESUME_AT
    if step not in ck.all_steps() or int(ck._read_step(step)[1][
            "state/trace_n"].max()) <= RING:
        raise AssertionError(f"window {step} is not a checkpoint past the "
                             f"ring: {ck.all_steps()}")
    eng2 = streamed_engine(built, dev, ckdir, every=0)
    sync(dev)
    t0 = time.perf_counter()
    rec = eng2.restore(step)
    sync(dev)
    restore_ms = (time.perf_counter() - t0) * 1e3
    st2 = eng2.run_local(state=rec.state)
    state_equal(st2, st)
    if eng2.trace_stream.merged() != ts.merged():
        raise AssertionError("resumed merged trace != the streamed run's")
    if eng2.metrics_stream.lines != ms.lines:
        raise AssertionError("resumed metrics records != the streamed run's")
    print(f"[streams] resumed from window {step} (trace_n "
          f"{rec.state.trace_n.tolist()}; restore {restore_ms:.3f} ms): "
          f"state (ring, trace_tail), merged trace and metrics records == "
          f"the uninterrupted streamed run ({card})", flush=True)
    return dict(windows=windows, events=events, wall=wall,
                host_reads=eng.host_reads, drains=eng.drains,
                drain_bytes=eng.drain_bytes, save_ms=ck.save_ms,
                ck_bytes=sizes, restore_ms=restore_ms, resume_step=step)


def phase_placement(card: str, built, main_run: dict, ckdir: str,
                    dev: str = "cuda") -> dict:
    """A placement at window MIGRATE_AT of the streamed run (its
    checkpoint, into a fresh streamed engine) from the counters' performance
    values, then on to the end: the oracle's trace, the migrate books
    balanced, ``route_rank`` launched over the whole pool."""
    import torch
    from repro_torch.core import monitoring as mon
    from repro_torch.core import scheduler
    from repro_torch.kernels import ops

    spec = built[3]
    shapes = []

    def route(keys):
        shapes.append(tuple(keys.shape))
        return ops.route_rank(keys, n_buckets=spec.n_agents + 1)

    eng = streamed_engine(built, dev, ckdir, every=0, route_fn=route)
    st = eng.restore(MIGRATE_AT).state
    la = st.world.lp_agent[0]
    owned = torch.bincount(la.long(), minlength=spec.n_agents)
    perf = scheduler.perf_values_from_counters(
        st.counters, owned, st.counters[:, mon.C_POOL_OCC])
    sync(dev)
    t0 = time.perf_counter()
    plan = scheduler.plan_placement(perf, st.world.lp_ctx[0],
                                    spec.n_agents)
    sync(dev)
    plan_ms = (time.perf_counter() - t0) * 1e3

    def migrate(new_la):
        shapes.clear()
        sync(dev)
        reset_launches()
        t0 = time.perf_counter()
        out = eng.apply_placement_local(st, new_la)
        sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        moved = int((out.counters - st.counters)[:, mon.C_MIGRATE_OUT].sum())
        return out, moved, ms, launches(), list(shapes)

    out, moved, ms, ran, seen = migrate(plan)
    how = "plan_placement"
    if moved == 0:
        out, moved, ms, ran, seen = migrate((la + 1) % spec.n_agents)
        how = "every LP one agent on (the plan moved nothing)"
    c = out.counters.sum(0).cpu()
    if not (int(c[mon.C_MIGRATE_OUT]) == int(c[mon.C_MIGRATE_IN]) > 0):
        raise AssertionError(f"migrate books {int(c[mon.C_MIGRATE_OUT])} out "
                             f"{int(c[mon.C_MIGRATE_IN])} in")
    if ran["route_rank"] != 1 or seen != [(spec.n_agents, spec.pool_cap)]:
        raise AssertionError(f"migration: route_rank launches "
                             f"{ran['route_rank']}, shapes {seen}")
    fin = eng.run_local(state=out)
    no_drop("placement", fin)
    if sorted(eng.trace_stream.merged()) != main_run["oracle"]:
        raise AssertionError("migrated run's merged trace != the oracle")
    n_lp_moved = int((plan != la).sum()) if how == "plan_placement" else \
        spec.n_lp
    print(f"[placement] window {MIGRATE_AT}: {how}, {n_lp_moved} of "
          f"{spec.n_lp} LPs moved (plan_placement {plan_ms:.3f} ms), perf "
          f"values {perf.tolist()}; {moved} pending events migrated (out "
          f"== in), apply_placement_local {ms:.3f} ms, route_rank "
          f"launched once at {seen[0]}; the continuation's merged trace == "
          f"the oracle in full-row order, no drop ({card})", flush=True)
    return dict(moved=moved, ms=ms, lps=n_lp_moved, plan_ms=plan_ms)


def phase_cli_resume(card: str, ckdir: str, dev: str = "cuda") -> dict:
    """``simulate t0t1`` killed by SIGKILL in a subprocess after the
    checkpoint at window 40 on the card, then ``--resume`` on the card and
    on the CPU from the same directory: each prints the uninterrupted run's
    line."""
    import contextlib
    import io
    import signal
    from repro_torch.launch import simulate

    whole = simulate.main([*CLI_T0T1, "--device", dev])
    t0 = time.perf_counter()
    killed = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.simulate", *CLI_T0T1,
         "--device", dev, "--checkpoint-dir", ckdir, "--checkpoint-every",
         "20", "--kill-after-window", "40"], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=SRC), timeout=600, cwd=ROOT)
    t_kill = time.perf_counter() - t0
    if killed.returncode != -signal.SIGKILL:
        raise AssertionError(f"--kill-after-window: exit "
                             f"{killed.returncode}: {killed.stderr[-2000:]}")
    took = {}
    for on in (dev, "cpu"):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            simulate.main([*CLI_T0T1, "--device", on, "--checkpoint-dir",
                           ckdir, "--resume"])
        took[on] = time.perf_counter() - t0
        lines = out.getvalue().splitlines()
        if lines != [f"[resume] window 40 from {ckdir}", *whole]:
            raise AssertionError(f"--resume --device {on}: {lines}")
    print(f"[simulate] t0t1 {' '.join(CLI_T0T1[1:])}: killed by SIGKILL "
          f"after the checkpoint at window 40 on {dev} (subprocess "
          f"{t_kill:.1f} s); --resume on {dev} ({took[dev]:.1f} s) and on "
          f"cpu ({took['cpu']:.1f} s) print the uninterrupted line "
          f"{whole[0]!r} ({card})", flush=True)
    return took


def phase_host_layer(card: str, main_run: dict, dev: str = "cuda",
                     grid: dict | None = None) -> dict:
    """Phase 4f: streams, resume, placement and the CLI's crash harness."""
    import tempfile
    from repro_torch.core import components as comps

    t0 = time.perf_counter()
    built = tiered_grid(comps, **(grid or {})).build(**tiered_build_kw())
    with tempfile.TemporaryDirectory() as tmp:
        out = phase_streams(card, built, main_run,
                            os.path.join(tmp, "streams"), dev)
        out["placement"] = phase_placement(
            card, built, main_run, os.path.join(tmp, "streams"), dev)
        out["cli"] = phase_cli_resume(card, os.path.join(tmp, "cli"), dev)
    print(f"[host layer] phase 4f: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


# --------------------------------------------------------------- phase 4g
ENS_REPLICAS = 256
ENS_FUSED = 32
ENS_TRACE = 4096
ENS_SOLO = (255,)
# the card-against-CPU cut: 16 farms over 4 agents, 4 replicas
ENS_CUT = dict(FAIL_KW, n_farms=16, n_agents=4)
ENS_CUT_SEEDS = (0, 37, 74, 111)
# the catalog's t0t1 at a 16-wide window, so a 32-row ring holds one
CLI_RUN_T0T1 = ["run", "t0t1", "--set", "exec_cap=16"]


def state_bytes(st) -> int:
    from repro_torch.core.engine import map_state
    sizes = []
    map_state(lambda x: sizes.append(x.numel() * x.element_size()), st)
    return sum(sizes)


def rows_seen(name: str, fn, seen: set):
    """``fn`` that records (name, rows of its first argument) per call."""
    def wrapped(x, *args, **kw):
        seen.add((name, int(x.shape[0])))
        return fn(x, *args, **kw)
    return wrapped


def profile_ensemble(eng, st, replicas: int, n: int = 10):
    """``profile_windows`` over the ensemble's stacked state: the engine's
    reductions and exchange grouped by replica, as ``run_ensemble`` runs
    them."""
    from repro_torch.kernels import ops
    eng._replicas = replicas
    try:
        with ops.lane_groups(replicas):
            return profile_windows(eng, st, n)
    finally:
        eng._replicas = 1


def phase_ensemble(card: str, built, solo_st, solo: dict,
                   bg: Background) -> dict:
    """Phase 4g: the ensemble of 256 full-width failure models on the card,
    then the ensemble and catalog entry points."""
    import dataclasses
    import functools
    import numpy as np
    import torch
    from repro_torch.core import Engine, merged_engine_trace
    from repro_torch.core import monitoring as mon
    from repro_torch.core.engine import map_state, seed_rng_fields
    from repro_torch.core.registry import registry_of
    from repro_torch.kernels import ops
    from repro_torch.scenarios import failures

    t_phase = time.perf_counter()
    R, spec = ENS_REPLICAS, built[3]
    A = spec.n_agents
    seeds = np.arange(R, dtype=np.int32)
    probe = Engine(*built, trace_cap=ENS_TRACE, device="cuda")
    per = state_bytes(probe.init_state())
    n_pay = built[2].payload.shape[-1]
    route = A * A * spec.route_cap * (6 * 4 + n_pay * 4 + 1)
    print(f"[ensemble] reckoned: {per / 1e6:.3f} MB of state a replica "
          f"({A} agents, pool_cap {spec.pool_cap}, trace {ENS_TRACE}) and "
          f"{route / 1e6:.3f} MB of route buffers; {R} replicas "
          f"{R * (per + route) / 1e9:.3f} GB", flush=True)
    del probe

    seen: set = set()
    reg = registry_of(built[0])
    hooks = dict(
        select_fn=rows_seen("select_events", ops.select_events, seen),
        group_fn=rows_seen("group_by_kind", functools.partial(
            ops.group_by_kind, n_kinds=reg.n_kinds), seen),
        route_fn=rows_seen("route_rank", functools.partial(
            ops.route_rank, n_buckets=A + 1), seen),
        trace_fn=rows_seen("trace_rank", ops.trace_rank, seen))
    eng = Engine(*built, trace_cap=ENS_TRACE, device="cuda", **hooks)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = eng.run_ensemble(seeds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ran = launches()
    peak = torch.cuda.max_memory_allocated()
    windows = out.windows[:, 0].cpu().numpy()
    steps = int(windows.max())
    c = out.counters.sum((0, 1)).cpu()
    events = int(c[mon.C_EVENTS])
    if not bool(out.done.all()):
        raise AssertionError("ensemble: a replica is not done")
    for i in mon.DROP_COUNTERS + (mon.C_TRACE_DROP,):
        if int(c[i]) != 0:
            raise AssertionError(f"ensemble: counter "
                                 f"{mon.BUILTIN_COUNTERS[i][0]} = {int(c[i])}")
    if int(out.trace_n.max()) > ENS_TRACE:
        raise AssertionError("ensemble: a trace outgrew its buffer")
    once = {k: ran[k] for k in STITCHED_HOOKS}
    if once != {k: steps for k in STITCHED_HOOKS}:
        raise AssertionError(f"ensemble: launches {once}, {steps} windows")
    if seen != {(k, R * A) for k in STITCHED_HOOKS}:
        raise AssertionError(f"ensemble: rows per launch {sorted(seen)}")
    if len(set(windows.tolist())) < 2:
        raise AssertionError("ensemble: every replica took the same windows")
    solo_rate = solo["events"] / solo["wall"]
    print(f"[ensemble] failures x {R} replicas stitched cuda: {steps} "
          f"windows (replicas {int(windows.min())}-{steps}), {events} "
          f"events, wall {wall:.3f} s, {events / wall:.1f} events/s (phase "
          f"4e's single run in this call: {solo['windows']} windows, "
          f"{solo['wall']:.3f} s, {solo_rate:.1f} events/s); "
          f"{wall / steps * 1e3:.3f} ms/window (4e "
          f"{solo['wall'] / solo['windows'] * 1e3:.3f}); host reads/window "
          f"{eng.host_reads / steps:.4f} (4e "
          f"{solo['host_reads'] / solo['windows']:.4f}); fallback "
          f"steps/window {eng.fallback_steps / steps:.2f} (4e "
          f"{solo['fallback_steps'] / solo['windows']:.2f}); fallback "
          f"rows/window {int(c[mon.C_BATCH_FALLBACK]) / steps:.2f}; launches "
          f"{ran}, every one at {R * A} rows; peak device memory "
          f"{peak / 2**30:.3f} GiB ({card})", flush=True)
    t0 = time.perf_counter()
    ms, ops_w, busy = profile_ensemble(eng, eng.ensemble_state(seeds), R)
    print(f"[ensemble] windows 0..10 profiled: {ms:.3f} ms/window, "
          f"{ops_w:.1f} device ops/window, device busy {busy:.4f} of the "
          f"wall ({card}; {time.perf_counter() - t0:.1f} s)", flush=True)

    # replica 0 (seed 0 perturbs nothing) is phase 4e's card run, whose
    # trace buffer is larger: the trace by its written rows
    r0 = map_state(lambda x: x[0], out)
    state_equal(r0, solo_st, parts=("world", "pool", "counters", "t_now",
                                     "done", "windows", "trace_n",
                                     "trace_tail"))
    for a, n in enumerate(r0.trace_n.tolist()):
        if not torch.equal(r0.trace[a, :n], solo_st.trace[a, :n]):
            raise AssertionError(f"ensemble replica 0: agent {a}'s trace")
    t0 = time.perf_counter()
    one_eng = Engine(*built, trace_cap=ENS_TRACE, device="cuda")
    for r in ENS_SOLO:
        one = one_eng.run_local(state=seed_rng_fields(
            one_eng.init_state(),
            torch.tensor(r, dtype=torch.int32, device="cuda")))
        state_equal(map_state(lambda x, r=r: x[r], out), one)
    t_solo = time.perf_counter() - t0
    r = ENS_SOLO[-1]
    want = bg.get("ensemble oracle")["trace"]
    rr = map_state(lambda x: x[r], out)
    if sorted(merged_engine_trace(rr.trace, rr.trace_n)) != sorted(want):
        raise AssertionError(f"ensemble replica {r}: trace != oracle")
    print(f"[ensemble] replica 0 == phase 4e's stitched card run (the trace "
          f"by its written rows); replicas {ENS_SOLO} == card run_local of "
          f"their seeded states ({t_solo:.1f} s); replica {r}'s merged "
          f"trace == the oracle of its seeded world in full-row order "
          f"({len(want)} events)", flush=True)

    # the fused front end, 32 replicas
    fspec = dataclasses.replace(spec, fused_select=True)
    reset_launches()
    t0 = time.perf_counter()
    fused = Engine(*built[:3], fspec, trace_cap=ENS_TRACE,
                   device="cuda").run_ensemble(seeds[:ENS_FUSED])
    torch.cuda.synchronize()
    f_wall = time.perf_counter() - t0
    f_ran = launches()
    state_equal(fused, map_state(lambda x: x[:ENS_FUSED], out))
    if f_ran["select_events"] or f_ran["group_by_kind"] or not (
            f_ran["fused_select"] and f_ran["ring_slots"]):
        raise AssertionError(f"fused ensemble: launches {f_ran}")
    print(f"[ensemble] fused x {ENS_FUSED} == the first {ENS_FUSED} "
          f"stitched replicas ({f_wall:.3f} s, launches {f_ran})",
          flush=True)
    del out, fused, rr, r0

    # card against cpu on a cut
    cut, _ = failures.build_failure_scenario(**ENS_CUT)
    t0 = time.perf_counter()
    on_card = Engine(*cut, trace_cap=ENS_TRACE,
                     device="cuda").run_ensemble(ENS_CUT_SEEDS)
    t_card = time.perf_counter() - t0
    state_equal(on_card, bg.get("cut cpu"))
    print(f"[ensemble] {len(ENS_CUT_SEEDS)} replicas of the "
          f"{ENS_CUT['n_farms']}-farm, {ENS_CUT['n_agents']}-agent cut (seeds "
          f"{list(ENS_CUT_SEEDS)}): cuda == cpu (cuda {t_card:.1f} s)",
          flush=True)
    entry = phase_ensemble_entry(card, bg)
    took = time.perf_counter() - t_phase
    print(f"[ensemble] phase 4g: {took:.1f} s", flush=True)
    return dict(wall=wall, events=events, windows=steps, launches=ran,
                entry=entry, seconds=took)


def phase_ensemble_entry(card: str, bg: Background) -> dict:
    """``simulate ensemble`` and ``simulate run`` on the card: the lines
    of ``--device cpu``, the injected preemption with the stream check, and
    the SIGKILL lane resumed by the same command."""
    import signal
    import tempfile
    from repro_torch.launch import simulate

    took: dict = {}

    def timed(key, argv):
        t0 = time.perf_counter()
        lines = simulate.main(argv)
        took[key] = time.perf_counter() - t0
        return lines

    ens = {"cuda": timed("ensemble", ["ensemble", "--device", "cuda"]),
           "cpu": bg.get("cli ensemble")}
    if ens["cuda"] != ens["cpu"]:
        raise AssertionError(f"simulate ensemble: {ens}")
    listing = timed("run --list", ["run", "--list", "--device", "cuda"])
    if len(listing) != 8:
        raise AssertionError(f"simulate run --list: {listing}")
    farm = {"cuda": timed("ensemble_farm",
                          ["run", "ensemble_farm", "--device", "cuda"]),
            "cpu": bg.get("cli run ensemble_farm")}
    if farm["cuda"] != farm["cpu"]:
        raise AssertionError(f"simulate run ensemble_farm: {farm}")
    with tempfile.TemporaryDirectory() as tmp:
        pre = timed("t0t1 preempted", [
            *CLI_RUN_T0T1, "--device", "cuda", "--checkpoint-dir",
            os.path.join(tmp, "pre"), "--preempt-at-window", "12",
            "--preempt-survivors", "1", "--stream-trace", "32",
            "--stream-check"])
        if "preempt=1 resume=1" not in pre[0] or not pre[1].startswith(
                "[stream-check] OK:"):
            raise AssertionError(f"simulate run t0t1 preempted: {pre}")
        whole = timed("t0t1", [*CLI_RUN_T0T1, "--device", "cuda"])[0]
        kill = [*CLI_RUN_T0T1, "--device", "cuda", "--checkpoint-dir",
                os.path.join(tmp, "kill")]
        t0 = time.perf_counter()
        dead = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.simulate", *kill,
             "--kill-after-window", "24"], capture_output=True, text=True,
            env=dict(os.environ, PYTHONPATH=SRC), timeout=600, cwd=ROOT)
        took["t0t1 killed"] = time.perf_counter() - t0
        if dead.returncode != -signal.SIGKILL or "[run]" in dead.stdout:
            raise AssertionError(f"--kill-after-window: exit "
                                 f"{dead.returncode}: {dead.stderr[-2000:]}")
        resumed = timed("t0t1 resumed", kill)[0]
        if resumed != whole.replace("preempt=0 resume=0",
                                    "preempt=1 resume=1"):
            raise AssertionError(f"run t0t1 resumed: {resumed!r} against "
                                 f"{whole!r}")
    secs = {k: round(v, 1) for k, v in took.items()}
    print(f"[ensemble] simulate ensemble: cuda == cpu: {ens['cuda'][1]!r}; "
          f"run --list: {len(listing) // 2} entries; run ensemble_farm: "
          f"cuda == cpu: {farm['cuda'][0]!r}; run t0t1 preempted at window "
          f"12: {pre[0]!r}, {pre[1]!r}; killed by SIGKILL after the "
          f"checkpoint at window 24 and resumed by the same command: "
          f"{resumed!r} (uninterrupted {whole!r}); seconds {secs} ({card})",
          flush=True)
    return took


# --------------------------------------------------------------- phase 4h
# The drivers across devices. A mesh is a list of devices, one a shard;
# with one card every shard is on it (as the reference's forced host
# devices share one CPU), so these runs show the shards' collectives and
# kernels at K rows, not multi-card scaling. Phase 4's tiered Grid at 8
# agents over 4 shards (K = 2), stitched, at full depth; then, at a cut
# depth of DIST_WINDOWS windows against run_local stepped as far: the fused
# front end on 4 shards, 3 shards (K = 3, one pad agent), 8 shards (K = 1),
# the adaptive driver,
# a placement, and a streamed, checkpointed run stopped at window
# DIST_STOP and resumed on 2 shards; the 64-flow grid at one agent a shard
# against the CPU; then the CLI.
DIST_WINDOWS = 48
DIST_STOP = 32
DIST_CK = 16
DIST_LADDER = (16, 64, 256)
DES_KERNELS = ("select_events", "group_by_kind", "trace_rank", "route_rank",
               "fused_select", "ring_slots")


def grid_64_flows(components):
    """tests/test_torch_network_64.py's 64-flow WAN region through a
    ``components`` module's builder, and its build kwargs."""
    c = components
    b = c.ScenarioBuilder(max_cpu=4, queue_cap=64, max_link=4, max_flow=64)
    b.add_regional_center(n_cpu=4, cpu_power=10.0, disk=500.0, tape=5000.0,
                          tape_rate=5.0)
    t1 = b.add_regional_center(n_cpu=4, cpu_power=8.0, disk=3000.0,
                               tape=30000.0, tape_rate=5.0)
    wan = b.add_net_region(link_bws=[0.5, 0.7, 3.0], link_lats=[5, 5, 5])
    routes = [dict(l0=0), dict(l0=0, l1=2), dict(l0=1, l1=2), dict(l0=1),
              dict(l0=2)]
    for route, count in zip(routes, (13, 13, 13, 13, 12)):
        b.add_generator(
            target_lp=wan, kind=c.FLOW_START,
            payload=c.FLOW_START.pack(size=40.0, **route,
                                      notify_lp=t1["farm"],
                                      notify_kind=c.JOB_SUBMIT.id,
                                      notify2_lp=t1["storage"],
                                      notify2_kind=c.DATA_WRITE.id),
            interval=1, count=count, start=0)
    return b, dict(n_agents=2, lookahead=2, t_end=70, pool_cap=512,
                   work_per_mb=2.0)


class kernel_rows:
    """Within the block, the ops wrappers of the window's kernels record
    (kernel, rows of the call) in ``seen``; an engine built inside binds
    them."""

    def __init__(self, seen: set):
        from repro_torch.kernels import ops
        self.ops, self.seen = ops, seen
        self.old = {n: getattr(ops, n) for n in DES_KERNELS}

    def __enter__(self):
        for n, fn in self.old.items():
            setattr(self.ops, n, rows_seen(n, fn, self.seen))

    def __exit__(self, *exc):
        for n, fn in self.old.items():
            setattr(self.ops, n, fn)


def run_sharded(label: str, built, mesh, dev: str, card: str,
                max_windows: int = 10_000, local: dict | None = None):
    """``run_distributed`` of ``built`` over ``mesh`` with the launch counts
    set to 0 before and read after, and the rows of every kernel call;
    each of the front end's kernels must launch once a window a shard at K
    rows. Returns (state, numbers)."""
    from repro_torch.core import Engine
    from repro_torch.core import monitoring as mon
    spec = built[3]
    D = len(mesh)
    K = -(-spec.n_agents // D)
    seen: set = set()
    with kernel_rows(seen):
        eng = Engine(*built, trace_cap=65536, device=dev)
    sync(dev)
    reset_launches()
    t0 = time.perf_counter()
    with kernel_rows(seen):
        st = eng.run_distributed(mesh, max_windows=max_windows)
    sync(dev)
    wall = time.perf_counter() - t0
    ran = launches()
    windows = int(st.windows[0])
    events = int(st.counters[:, mon.C_EVENTS].sum())
    hooks = FUSED_HOOKS if spec.fused_select else STITCHED_HOOKS
    if dev == "cuda":
        want = {k: D * windows for k in hooks}
        if {k: ran[k] for k in hooks} != want:
            raise AssertionError(f"{label}: launches {ran}, want {want}")
        off = [k for k in DES_KERNELS if k not in hooks and ran[k]]
        if off:
            raise AssertionError(f"{label}: {off} launched")
    if seen != {(k, K) for k in hooks}:
        raise AssertionError(f"{label}: (kernel, rows) calls {sorted(seen)}, "
                             f"want every hook at {K} rows")
    no_drop(label, st)
    ms = wall / windows * 1e3
    side = ""
    if local is not None:
        side = (f"; run_local: {local['wall'] / local['windows'] * 1e3:.3f} "
                f"ms/window, {local['events'] / local['wall']:.1f} events/s, "
                f"{local['host_reads'] / local['windows']:.4f} host reads/"
                f"window")
    print(f"[distributed] {label}: {D} shards x K={K} ({D * K - spec.n_agents}"
          f" pad), {windows} windows, {events} events, wall {wall:.3f} s, "
          f"{ms:.3f} ms/window, {events / wall:.1f} events/s, "
          f"{eng.host_reads / windows:.4f} host reads/window, fallback "
          f"steps/window {eng.fallback_steps / windows:.2f}{side}; launches "
          f"{ran} ({D} a window each at {K} rows) ({card})", flush=True)
    return st, dict(windows=windows, events=events, wall=wall,
                    host_reads=eng.host_reads, launches=ran)


def exchange_cost(built, mesh, dev: str, card: str, n: int = 20) -> dict:
    """The exchange alone on the send buffers of the first window that
    routes a valid row (captured from ``ShardAxes.exchange``): its host ms
    a call (the Python call, unsynchronized) and device ms a call (its ops'
    device time under torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import Engine
    from repro_torch.core import shards as sh
    got = []
    real = sh.ShardAxes.exchange

    def capture(axes, cols, rcap):
        if not got and any(bool(c[-1].any()) for c in cols):
            got.append((axes, cols, rcap))
        return real(axes, cols, rcap)

    sh.ShardAxes.exchange = capture
    try:
        Engine(*built, trace_cap=65536, device=dev).run_distributed(
            mesh, max_windows=16)
    finally:
        sh.ShardAxes.exchange = real
    if not got:
        raise AssertionError("no exchange carried a valid row in 16 windows")
    axes, cols, rcap = got[0]
    nbytes = sum(c.numel() * c.element_size() for sc in cols for c in sc)
    real(axes, cols, rcap)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        real(axes, cols, rcap)
    host_ms = (time.perf_counter() - t0) / n * 1e3
    sync(dev)
    dev_ms = None
    if dev == "cuda":
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                real(axes, cols, rcap)
            torch.cuda.synchronize()
        ops_ = device_ops(prof)
        dev_ms = sum(e.duration_ns() for e in ops_) / 1e6 / n
        print(f"[distributed] exchange over {axes.n_shards} shards x "
              f"K={axes.n_lanes}: {nbytes} bytes of send buffers, host "
              f"{host_ms:.4f} ms a call, device {dev_ms:.4f} ms a call in "
              f"{len(ops_) / n:.1f} device ops ({card})", flush=True)
    return dict(host_ms=host_ms, device_ms=dev_ms, bytes=nbytes)


def profile_sharded(built, mesh, st, start: int, card: str,
                    n: int = 10) -> None:
    """``n`` windows of ``run_distributed`` from ``st`` (a ``run_local``
    state at window ``start``, which the sharded run's equals) under
    torch.profiler: ms a window, device ops, busy share and the host ms of
    each labelled step (``window.exchange`` the exchange's own)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import Engine
    eng = Engine(*built, trace_cap=65536, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run_distributed(mesh, max_windows=start + n, state=st)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / n * 1e3
    kern = device_ops(prof)
    if not kern:
        raise AssertionError("the sharded profile holds no device op")
    busy = sum(e.duration_ns() for e in kern) / 1e6 / n
    tag = f"[profile {len(mesh)} shards]"
    print(f"{tag} windows {start}..{start + n}: {ms:.3f} ms/window "
          f"profiled; {len(kern) / n:.1f} device ops/window, device busy "
          f"{busy:.3f} ms/window = {busy / ms:.4f} of the wall ({card})",
          flush=True)
    for key, (ns, calls) in sorted(host_spans(prof).items()):
        print(f"{tag} {key}: host {ns / 1e6 / n:.3f} ms/window, "
              f"{calls / n:.2f} calls/window", flush=True)


def phase_distributed(card: str, main_run: dict, bg: Background,
                      dev: str = "cuda", grid: dict | None = None) -> dict:
    """Phase 4h: the drivers across devices (see above)."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core import components as comps
    from repro_torch.core import Engine, merged_engine_trace
    from repro_torch.core import monitoring as mon
    from repro_torch.core.policy import ExecPolicy
    from repro_torch.launch import simulate
    from repro_torch.launch.mesh import make_sim_mesh

    t_phase = time.perf_counter()
    out = {}
    mesh = make_sim_mesh(DIST_D, dev)
    cards = torch.cuda.device_count() if dev == "cuda" else 0
    print(f"[distributed] mesh {[str(d) for d in mesh]}: {DIST_D} shards on "
          f"{len(set(mesh))} distinct device(s), {cards} card(s) present; "
          f"shards on one card queue their kernels on it, so no number here "
          f"is multi-card scaling ({card})", flush=True)

    def tiered(**kw):
        return tiered_grid(comps, **(grid or {})).build(**tiered_build_kw(),
                                                       **kw)

    laps = [time.perf_counter()]

    def lap(step: str) -> None:
        laps.append(time.perf_counter())
        print(f"[time] 4h {step}: {laps[-1] - laps[-2]:.1f} s", flush=True)

    def cut_local(built):
        """``run_local`` of ``built`` stepped DIST_WINDOWS windows, and its
        numbers for the sharded runs' lines."""
        eng = Engine(*built, trace_cap=65536, device=dev)
        sync(dev)
        t0 = time.perf_counter()
        st = eng.run_local(max_windows=DIST_WINDOWS)
        sync(dev)
        return eng, st, dict(wall=time.perf_counter() - t0,
                             windows=DIST_WINDOWS, host_reads=eng.host_reads,
                             events=int(st.counters[:, mon.C_EVENTS].sum()))

    # stitched at full depth on 4 shards: byte-equal to phase 4's card
    # run_local and the oracle
    label = "tiered_grid stitched"
    st, out["stitched"] = run_sharded(label, tiered(), mesh, dev, card,
                                      local=main_run)
    state_equal(st, main_run["state"])
    if sorted(merged_engine_trace(st.trace, st.trace_n)) != \
            main_run["oracle"]:
        raise AssertionError(f"{label}: merged trace != the oracle")
    print(f"[distributed] {label} on {DIST_D} shards == phase 4's card "
          f"run_local (trace, counters, world, pool, ring cursors); merged "
          f"trace == the oracle", flush=True)
    lap("stitched, 4 shards, full depth")

    # the rest at a cut depth against run_local stepped as far: the fused
    # front end on 4 shards, then 3 shards (a pad agent) and 8 (K = 1)
    label = f"tiered_grid fused, windows 0..{DIST_WINDOWS}"
    fused = tiered(fused_select=True)
    _, f_ref, f_local = cut_local(fused)
    st, out["fused"] = run_sharded(label, fused, mesh, dev, card,
                                   max_windows=DIST_WINDOWS, local=f_local)
    state_equal(st, f_ref)
    if merged_engine_trace(st.trace, st.trace_n) != merged_engine_trace(
            f_ref.trace, f_ref.trace_n):
        raise AssertionError(f"{label}: merged trace != run_local's")
    print(f"[distributed] {label} on {DIST_D} shards == fused run_local at "
          f"window {DIST_WINDOWS} (trace, counters, world, pool, ring "
          f"cursors)", flush=True)
    built = tiered()
    eng, ref, local = cut_local(built)
    for D in (3, 8):
        st, out[f"D{D}"] = run_sharded(
            f"tiered_grid stitched, windows 0..{DIST_WINDOWS}", built,
            make_sim_mesh(D, dev), dev, card, max_windows=DIST_WINDOWS,
            local=local)
        state_equal(st, ref)
        print(f"[distributed] {D} shards == run_local at window "
              f"{DIST_WINDOWS}", flush=True)
    lap(f"fused 4 shards, 3 and 8 shards, {DIST_WINDOWS} windows")

    # one agent a shard on the 64-flow grid: the one-lane flow order
    b64, kw64 = grid_64_flows(comps)
    g64 = b64.build(**kw64)
    st = Engine(*g64, trace_cap=1024, device=dev).run_distributed(
        make_sim_mesh(2, dev))
    state_equal(st, bg.get("grid64 cpu"))
    loc = Engine(*g64, trace_cap=1024, device=dev).run_local()
    n_diff = int((st.world.flow_rate.view(torch.int32)
                  != loc.world.flow_rate.view(torch.int32)).sum())
    if n_diff == 0:
        raise AssertionError("grid_64_flows: 2 shards of one agent equal "
                             "run_local at 2 agents; the one-lane order "
                             "did not show")
    print(f"[distributed] grid_64_flows, 2 agents on 2 shards (K = 1): == the "
          f"CPU port's run_distributed; {n_diff} flow_rate elements differ "
          f"from run_local at 2 agents (one lane a shard sums in the "
          f"one-lane order, as the reference's run_distributed does)",
          flush=True)
    lap("grid_64_flows")

    # the adaptive driver's rungs in lockstep with run_adaptive
    pol = ExecPolicy(ladder=DIST_LADDER)
    e1 = Engine(*built, trace_cap=65536, device=dev)
    a_ref = e1.run_adaptive(max_windows=DIST_WINDOWS, policy=pol)
    e2 = Engine(*built, trace_cap=65536, device=dev)
    sync(dev)
    t0 = time.perf_counter()
    a_got = e2.run_distributed_adaptive(mesh, max_windows=DIST_WINDOWS,
                                        policy=pol)
    sync(dev)
    t_ada = time.perf_counter() - t0
    if e2.adaptive_rungs != e1.adaptive_rungs:
        raise AssertionError(f"adaptive rungs {e2.adaptive_rungs} != "
                             f"run_adaptive's {e1.adaptive_rungs}")
    state_equal(a_got, a_ref)
    print(f"[distributed] run_distributed_adaptive over {DIST_LADDER} on "
          f"{DIST_D} shards, {len(e2.adaptive_rungs)} windows: rungs "
          f"{sorted(set(e2.adaptive_rungs))} == run_adaptive's, state == "
          f"run_adaptive's ({t_ada / len(e2.adaptive_rungs) * 1e3:.3f} "
          f"ms/window, {e2.host_reads / len(e2.adaptive_rungs):.4f} host "
          f"reads/window) ({card})", flush=True)
    lap("adaptive")

    # a placement in mid-run, across the shards and on one device
    la = ref.world.lp_agent[0].cpu().numpy()
    new_la = ((la + 1) % built[3].n_agents).astype(np.int32)
    sync(dev)
    t0 = time.perf_counter()
    m_loc = eng.apply_placement_local(ref, new_la)
    sync(dev)
    t1 = time.perf_counter()
    m_dist = eng.apply_placement_distributed(ref, new_la, mesh)
    sync(dev)
    t2 = time.perf_counter()
    state_equal(m_dist, m_loc)
    moved = int(m_dist.counters[:, mon.C_MIGRATE_OUT].sum())
    if moved == 0 or moved != int(m_dist.counters[:, mon.C_MIGRATE_IN].sum()):
        raise AssertionError(f"placement: out/in unbalanced or empty")
    print(f"[distributed] apply_placement_distributed at window "
          f"{DIST_WINDOWS} on {DIST_D} shards == apply_placement_local: "
          f"{moved} events out and in; {(t2 - t1) * 1e3:.3f} ms (local "
          f"{(t1 - t0) * 1e3:.3f} ms) ({card})", flush=True)

    # streamed and checkpointed, stopped, resumed on another shard count
    class Stop(RuntimeError):
        pass

    def stop(window, _st):
        if window >= DIST_STOP:
            raise Stop

    with tempfile.TemporaryDirectory() as ckdir:
        e1 = streamed_engine(built, dev, ckdir, every=DIST_CK,
                             window_hook=stop)
        try:
            e1.run_distributed(mesh)
        except Stop:
            pass
        e2 = streamed_engine(built, dev, ckdir, every=DIST_CK)
        rec = e2.restore()
        if rec.step != DIST_STOP:
            raise AssertionError(f"resume from window {rec.step}")
        got = e2.run_distributed(make_sim_mesh(2, dev),
                                 max_windows=DIST_WINDOWS - DIST_STOP,
                                 state=rec.state)
    state_equal(got, ref, parts=("world", "pool", "counters", "t_now",
                                 "windows", "trace_n"))
    if e2.trace_stream.merged() != merged_engine_trace(ref.trace,
                                                       ref.trace_n):
        raise AssertionError("resumed streamed trace != run_local's")
    no_drop("resumed", got)
    print(f"[distributed] streamed through a {RING}-row ring on {DIST_D} "
          f"shards, checkpointed every {DIST_CK}, stopped at window "
          f"{DIST_STOP}, resumed on 2 shards to window {DIST_WINDOWS}: == "
          f"run_local (world, pool, counters) and its merged trace, "
          f"C_TRACE_DROP 0; {len(e1.checkpointer.save_ms)} saves, "
          f"{np.mean(e1.checkpointer.save_ms):.1f} ms each ({card})",
          flush=True)
    lap("placement, stream and resume")

    # the exchange's cost, then a profile of the sharded window from the
    # cut run_local's state
    out["exchange"] = exchange_cost(built, mesh, dev, card)
    if dev == "cuda":
        profile_sharded(built, mesh, ref, DIST_WINDOWS, card)
    lap("exchange cost and profile")

    # the entry points
    t0 = time.perf_counter()
    line = simulate.main(["distributed", "--devices", str(DIST_D),
                          "--device", dev])
    t_cli = time.perf_counter() - t0
    lap("simulate distributed")
    want = bg.get(f"cli distributed --devices {DIST_D}")
    if line != want:
        raise AssertionError(f"simulate distributed: {line} != cpu {want}")
    with tempfile.TemporaryDirectory() as ckdir:
        run = simulate.main([*CLI_RUN_T0T1, "--devices", "2", "--device",
                             dev, "--checkpoint-dir", ckdir,
                             "--checkpoint-every", "4",
                             "--preempt-at-window", "12",
                             "--preempt-survivors", "1", "--stream-trace",
                             "32", "--stream-check"])
    if "reshard=1" not in run[0] or not run[1].startswith(
            "[stream-check] OK"):
        raise AssertionError(f"simulate run --devices 2 preempted: {run}")
    print(f"[distributed] simulate distributed --devices {DIST_D}: {dev} == "
          f"cpu {line[0]!r} ({t_cli:.1f} s); simulate run t0t1 --devices 2 "
          f"preempted at window 12 to 1 survivor: {run[0]!r}, "
          f"{run[1]!r} ({card})", flush=True)
    lap("simulate run --devices 2")
    print(f"[distributed] phase 4h: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return out


# --------------------------------------------------------------- phase 3z
ZOO_TOL = {"float32": dict(atol=2e-6, rtol=2e-6),
           "bfloat16": dict(atol=2e-2, rtol=2e-2)}
GLA_TOL = dict(atol=5e-5, rtol=5e-4)


def zoo_close(name: str, got, want, tol: dict) -> float:
    """Max abs error of ``got`` against ``want`` (as float32); raises
    unless every value is finite and within ``tol``."""
    import torch
    g, w = got.float(), want.float()
    if g.shape != w.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} vs "
                             f"{want.dtype} {tuple(want.shape)}")
    if not bool(torch.isfinite(g).all()) or not bool(torch.isfinite(w).all()):
        raise AssertionError(f"{name}: a value is not finite")
    if not torch.allclose(g, w, **tol):
        raise AssertionError(f"{name}: max abs error "
                             f"{float((g - w).abs().max())} outside {tol}")
    return float((g - w).abs().max())


def attention_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs a head attends: what the function needs."""
    if not causal:
        return sq * skv
    return sum(min(i + 1, window) if window > 0 else i + 1 for i in range(sq))


def gla_flops(s: int, c: int, dk: int, dv: int, mode: str,
              state_products: int = 1) -> int:
    """Float operations of one head's chunked scan (products and sums of
    the intra-chunk matrix, its product with V, the state read and the
    state update, the last ``state_products`` times: the tensor-core
    kernel splits it into two TF32 products), counting only the triangle
    the mode needs."""
    tri = c * (c - 1) // 2 if mode == "k" else c * (c + 1) // 2
    per_chunk = 2 * (tri * dk + c * dk * dv + c * (c + 1) // 2 * dv
                     + state_products * c * dk * dv)
    return per_chunk * (s // c)


# flash attention at the shapes the moe, vlm and encdec families give it,
# (B, H, KV, Sq, Skv, D, causal, window) at the serve batch: whisper's
# encoder (non-causal over its 1,500 frames), its cross-attention (4
# decoder tokens over the 1,500 frames) and moonshot's prefill (D 128,
# group 1, S 2048); checked in both dtypes, timed in bfloat16
FA_FAMILY_SHAPES = {
    "whisper encoder": (4, 20, 20, 1500, 1500, 64, False, 0),
    "whisper cross": (4, 20, 20, 4, 1500, 64, False, 0),
    "moonshot prefill": (4, 16, 16, 2048, 2048, 128, True, 0)}

# the kernel each (mode, dtype) runs: bf16 on the tensor cores, float32
# gla_kernel
GLA_KERNEL = {("k", "bfloat16"): "rwkv6_tc_kernel",
              ("v", "bfloat16"): "ssd_tc_kernel"}


def phase_zoo_kernels() -> dict:
    """Flash attention and both GLA modes against their plain versions at
    the serve path's shapes, then timed (the bfloat16 main shapes)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan as gla
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(3)

    def rn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g) * scale).to(dev, dtype)

    err = {"flash_attention": 0.0, "rwkv6_scan": 0.0, "ssd_scan": 0.0}
    # (B, H, KV, S, D, causal, window): hymba's prefill at the serve batch,
    # window 0, a length that is no multiple of the tiles, a non-causal call
    # (KV length 2 S), the smoke configs' head dim 16; then the edges of the
    # bf16 kernel's 128-row query blocks and 64-key tiles: a window that is
    # no multiple of either, D 128 (two TMA boxes a row) with a window,
    # non-causal with Sq and Skv no multiples of either; then causal calls
    # with Sq != Skv (the reference's mask has no offset), fewer queries
    # than keys and more, with and without a window: at Sq 1000, Skv 300,
    # window 100 rows 399 on have no key in their band (the mean of every
    # value, as the reference's softmax of -1e30 scores gives)
    fa_cases = [(4, 25, 5, 2048, 64, True, 1024), (4, 25, 5, 2048, 64, True, 0),
                (2, 25, 5, 1000, 64, True, 1024), (2, 6, 2, 100, 128, False, 0),
                (2, 4, 2, 32, 16, True, 32), (1, 9, 3, 130, 32, True, 64),
                (2, 25, 5, 1000, 64, True, 100),
                (1, 10, 2, 2048, 128, True, 1024),
                (2, 9, 3, 130, 64, False, 0)]
    fa_cases = [c[:4] + (c[3] if c[5] else 2 * c[3],) + c[4:]
                for c in fa_cases] + [
        (2, 25, 5, 300, 1000, 64, True, 0),
        (2, 25, 5, 1000, 300, 64, True, 100),
        (1, 10, 2, 130, 700, 128, True, 100),
        (1, 9, 3, 700, 130, 32, True, 0)] + list(FA_FAMILY_SHAPES.values())
    fa_kernel = {"float32": "FFMA kernel", "bfloat16": "wgmma kernel"}
    main_fa = None
    cross_err = {"float32": 0.0, "bfloat16": 0.0}
    for B, H, KV, S, skv, D, causal, win in fa_cases:
        for dt in ("float32", "bfloat16"):
            tdt = getattr(torch, dt)
            q, k, v = (rn(B * h, n, D, dtype=tdt) for h, n in
                       ((H, S), (KV, skv), (KV, skv)))
            e = zoo_close(f"flash_attention {B}x{H}/{KV} S={S} Skv={skv} "
                          f"D={D} causal={causal} window={win} {dt}",
                          fa.flash_attention(q, k, v, causal=causal,
                                             window=win),
                          ref.attention(q, k, v, causal=causal, window=win),
                          ZOO_TOL[dt])
            print(f"[zoo kernels] flash_attention B={B} H={H} KV={KV} S={S} "
                  f"Skv={skv} D={D} causal={causal} window={win} {dt} "
                  f"({fa_kernel[dt]}): max abs err {e:.3e} (tolerance "
                  f"{ZOO_TOL[dt]})", flush=True)
            if main_fa is None and dt == "bfloat16":
                main_fa = (q, k, v, B, H, KV, S, D, win)
                err["flash_attention"] = e
            if causal and S != skv:
                cross_err[dt] = max(cross_err[dt], e)
    print(f"[zoo kernels] flash_attention causal Sq != Skv: largest error "
          f"float32 {cross_err['float32']:.3e} (tolerance 2e-6), bfloat16 "
          f"{cross_err['bfloat16']:.3e} (tolerance 2e-2)", flush=True)
    # (BH, S, dk, dv, chunk, mode): rwkv6-7b's time mix and hymba's SSD at
    # the serve batch; S 1000 takes the divisor rule's chunk 50; the smoke
    # configs' widths; the SSD kernel's edges: dk 64 (its largest state),
    # and dk 24 with dv 40 (a state block half padded, a last slice of 8
    # columns) at chunk 40
    gla_cases = [(4 * 64, 2048, 64, 64, 64, "k"), (4 * 25, 2048, 16, 64, 64, "v"),
                 (2 * 64, 1000, 64, 64, 50, "k"), (2 * 25, 1000, 16, 64, 50, "v"),
                 (8, 48, 16, 16, 16, "k"), (8, 32, 8, 16, 16, "v"),
                 (16, 512, 64, 64, 64, "v"), (8, 200, 24, 40, 40, "v")]
    main_gla = {}
    for bh, S, dk, dv, chunk, mode in gla_cases:
        name = "rwkv6_scan" if mode == "k" else "ssd_scan"
        for dt in ("float32", "bfloat16"):
            tdt = getattr(torch, dt)
            q, k = (rn(bh, S, dk, scale=0.5, dtype=tdt) for _ in range(2))
            v = rn(bh, S, dv, scale=0.5, dtype=tdt)
            w = torch.exp(-torch.exp(rn(bh, S, dk if mode == "k" else dv)
                                     * 0.5 - 1.0))
            u = rn(bh, dk, scale=0.3) if mode == "k" else None
            out, st = gla.gla_scan(q, k, v, w, u, mode=mode, chunk=chunk)
            want, wst = ref.gla_scan(q, k, v, w, u, mode=mode, chunk=chunk)
            label = (f"{name} BH={bh} S={S} dk={dk} dv={dv} chunk={chunk} "
                     f"{dt} ({GLA_KERNEL.get((mode, dt), 'gla_kernel')})")
            out_tol = GLA_TOL if dt == "float32" else ZOO_TOL[dt]
            e = zoo_close(label, out, want, out_tol)
            es = zoo_close(label + " state", st, wst, GLA_TOL)
            print(f"[zoo kernels] {label}: max abs err out {e:.3e} "
                  f"(tolerance {out_tol}), state {es:.3e} (tolerance "
                  f"{GLA_TOL})", flush=True)
            if name not in main_gla and dt == "bfloat16":
                main_gla[name] = (q, k, v, w, u, mode, chunk)
                err[name] = e
    ssd_refuses_unaligned(gla, main_gla["ssd_scan"])

    out = {}
    fq, fk, fv, B, H, KV, S, D, win = main_fa
    qpos = torch.arange(S, device=dev)
    band = (qpos[None, :] <= qpos[:, None]) & (qpos[None, :]
                                               > qpos[:, None] - win)
    q4, k4, v4 = (x.view(B, x.shape[0] // B, S, D) for x in (fq, fk, fv))
    sdpa = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=band,
                                          enable_gqa=True)
    zoo_close("scaled_dot_product_attention (yardstick)",
              sdpa.reshape(B * H, S, D),
              ref.attention(fq, fk, fv, causal=True, window=win),
              ZOO_TOL["bfloat16"])
    rows = {"flash_attention": dict(
        fn=lambda: fa.flash_attention(fq, fk, fv, causal=True, window=win),
        plain=lambda: ref.attention(fq, fk, fv, causal=True, window=win),
        lib=lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=band, enable_gqa=True),
        bytes=2 * (fq.numel() * 2 + fk.numel() + fv.numel()),
        ops=4 * D * B * H * attention_pairs(S, S, True, win),
        rate=BF16_OPS_PER_S, kernel="fa_wgmma_kernel")}
    for name, (q, k, v, w, u, mode, chunk) in main_gla.items():
        bh, S, dk = q.shape
        dv = v.shape[-1]
        kernel = GLA_KERNEL.get((mode, "bfloat16"), "gla_kernel")
        tc = kernel != "gla_kernel"
        rows[name] = dict(
            fn=lambda a=(q, k, v, w, u, mode, chunk): gla.gla_scan(
                *a[:5], mode=a[5], chunk=a[6]),
            plain=lambda a=(q, k, v, w, u, mode, chunk): ref.gla_scan(
                *a[:5], mode=a[5], chunk=a[6]),
            lib=None,
            # q, k, v and out in bfloat16, w and u in float32, the float32
            # state written once
            bytes=(2 * (q.numel() + k.numel() + v.numel() + bh * S * dv)
                   + 4 * (w.numel() + (u.numel() if u is not None else 0))
                   + 4 * bh * dk * dv),
            ops=bh * gla_flops(S, chunk, dk, dv, mode, 2 if tc else 1),
            rate=TF32_OPS_PER_S if tc else FP32_OPS_PER_S, kernel=kernel)
    for label, (B, H, KV, S, skv, D, causal, win) in FA_FAMILY_SHAPES.items():
        q, k, v = (rn(B * h, n, D, dtype=torch.bfloat16) for h, n in
                   ((H, S), (KV, skv), (KV, skv)))
        q4, k4, v4 = (x.view(B, x.shape[0] // B, x.shape[1], D)
                      for x in (q, k, v))
        rows[f"flash_attention {label}"] = dict(
            fn=lambda a=(q, k, v, causal): fa.flash_attention(
                *a[:3], causal=a[3]),
            plain=lambda a=(q, k, v, causal): ref.attention(*a[:3],
                                                            causal=a[3]),
            lib=lambda a=(q4, k4, v4, causal): F.scaled_dot_product_attention(
                *a[:3], is_causal=a[3]),
            bytes=2 * (q.numel() * 2 + k.numel() + v.numel()),
            ops=4 * D * B * H * attention_pairs(S, skv, causal, win),
            rate=BF16_OPS_PER_S, kernel="fa_wgmma_kernel", json=False)
    for name, r in rows.items():
        ms = cuda_ms(r["fn"], iters=50)
        dev_ms = device_ms(r["fn"], r["kernel"])
        plain_ms = cuda_ms(r["plain"], iters=20)
        lib_ms = cuda_ms(r["lib"], iters=50) if r["lib"] is not None else None
        bms, by = bound(r["bytes"], r["ops"], r["rate"])
        tflops, peak = r["ops"] / ms / 1e9, r["rate"] / 1e12
        # the family shapes are printed; the kernels line takes the main ones
        if r.get("json", True):
            out[name] = dict(max_abs_err=err[name], ms=ms, device_ms=dev_ms,
                             plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=bms, bound_by=by)
        print(f"[zoo kernels] {name}: kernel {ms:.6f} ms (device "
              f"{dev_ms:.6f} ms), plain {plain_ms:.6f} ms, library "
              f"{lib_ms if lib_ms is None else f'{lib_ms:.6f}'} ms, bound "
              f"{bms:.6f} ms ({by}: {r['bytes']} B, {r['ops']} ops); "
              f"{tflops:.1f} TFLOP/s ({tflops / peak:.4f} of {peak:.0f} "
              f"TFLOP/s), {bms / ms:.4f} of the bound; device "
              f"{r['ops'] / dev_ms / 1e9:.1f} TFLOP/s, {bms / dev_ms:.4f} of "
              f"the bound", flush=True)
    return out


def ssd_refuses_unaligned(gla, args) -> None:
    """The bf16 SSD kernel copies 16 B a thread: a q that is not 16-byte
    aligned is refused by the wrapper and by the launcher, never run."""
    import torch
    from repro_torch.kernels import build
    q, k, v, w, _u, mode, chunk = args
    bh, S, dk = q.shape
    dv = v.shape[-1]
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=q.device)
    qm = buf[1:].view(q.shape)
    qm.copy_(q)
    try:
        gla.gla_scan(qm, k, v, w, mode=mode, chunk=chunk)
    except ValueError as e:
        if "16-byte" not in str(e):
            raise
    else:
        raise AssertionError("ssd_scan ran a q that is not 16-byte aligned")
    out = torch.empty_like(v)
    st = torch.empty((bh, dk, dv), dtype=torch.float32, device=q.device)
    err = build.library("rwkv6_scan").launch_gla_scan(
        qm.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), None,
        out.data_ptr(), st.data_ptr(), bh, S, dk, dv, chunk, 0, 1,
        torch.cuda.current_stream().cuda_stream)
    if err == 0:
        raise AssertionError("launch_gla_scan took a q that is not 16-byte "
                             "aligned")
    print(f"[zoo kernels] ssd_scan bfloat16 with q 2 B off 16-byte "
          f"alignment: the wrapper raises, the launcher returns {err}",
          flush=True)


# --------------------------------------------------------------- phase 4s
def serve_full(arch: str, card: str, profile: bool = True, **cut) -> dict:
    """``ServeEngine`` at full width in bfloat16 on the card, at full depth
    unless ``cut`` (say ``n_layers=20``) cuts it: 4 requests of 2048 random
    tokens in 4 slots, 16 new tokens each; then, if ``profile``, a profiled
    admit and three ticks."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    slots, prompt, max_new = 4, 2048, 16
    cfg = dataclasses.replace(get_config(arch), cache_headroom=max_new,
                              **cut)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    eng = ServeEngine(model, batch_slots=slots, prompt_len=prompt)
    g = torch.Generator().manual_seed(1)
    reqs = [Request(rid=i, tokens=torch.randint(1, cfg.vocab, (prompt,),
                                                generator=g).tolist(),
                    max_new=max_new) for i in range(slots)]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    def finite(where):
        if not bool(torch.isfinite(eng.logits).all()):
            raise AssertionError(f"{arch}: a logit is not finite at {where}")

    reset_launches()
    t0 = time.perf_counter()
    eng.admit(reqs)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    ran = launches()
    check_launches(f"{arch} admit", ran, cfg)
    finite("the admit")
    tick_s = []
    while not all(r.done for r in reqs):
        t0 = time.perf_counter()
        eng.tick()     # ends in a host read of the sampled tokens
        tick_s.append(time.perf_counter() - t0)
        finite(f"tick {len(tick_s)}")
        if len(tick_s) > max_new:
            raise AssertionError(f"{arch}: requests not done after "
                                 f"{len(tick_s)} ticks")
    ticks, decode_s = len(tick_s), sum(tick_s)
    tokens = sum(len(r.out) for r in reqs)
    for r in reqs:
        if len(r.out) != max_new or not all(0 <= t < cfg.vocab
                                            for t in r.out):
            raise AssertionError(f"{arch} request {r.rid}: {r.out}")
    peak = torch.cuda.max_memory_allocated()
    if profile:
        profile_serve(eng, lambda: [Request(rid=r.rid, tokens=r.tokens,
                                            max_new=max_new) for r in reqs],
                      arch, card)
    nums = dict(params=n_params, init_s=init_s, prefill_s=prefill_s,
                decode_ms_per_tick=decode_s / ticks * 1e3, ticks=ticks,
                first_tick_ms=tick_s[0] * 1e3,
                later_tick_ms=sum(tick_s[1:]) / (ticks - 1) * 1e3,
                tokens=tokens, tokens_per_s=tokens / (prefill_s + decode_s),
                decode_tokens_per_s=slots * ticks / decode_s,
                prompt_tokens_per_s=slots * prompt / prefill_s,
                peak_gib=peak / 2**30, admit_launches=ran)
    depth = (f"depth cut to {cut}" if cut else "full depth")
    print(f"[serve] {arch} full width, {depth} ({n_params} params, "
          f"bfloat16): {slots} requests x {prompt} prompt tokens, "
          f"{max_new} new each: prefill {prefill_s:.3f} s "
          f"({nums['prompt_tokens_per_s']:.1f} prompt tok/s), decode "
          f"{nums['decode_ms_per_tick']:.3f} ms per tick over {ticks} ticks "
          f"(the first {nums['first_tick_ms']:.3f} ms, the others "
          f"{nums['later_tick_ms']:.3f} ms; "
          f"{nums['decode_tokens_per_s']:.1f} tok/s), {tokens} tokens in "
          f"{prefill_s + decode_s:.3f} s ({nums['tokens_per_s']:.1f} tok/s), "
          f"peak memory {nums['peak_gib']:.3f} GiB, weights drawn in "
          f"{init_s:.2f} s; admit launches {ran} ({card})", flush=True)
    del eng, model
    torch.cuda.empty_cache()
    return nums


# the zoo kernels' device op names (attention's two, the scans')
PORT_KERNELS = ("fa_wgmma_kernel", "fa_ffma_kernel", "gla_kernel",
                "rwkv6_tc_kernel", "ssd_tc_kernel")


def profile_serve(eng, make_reqs, arch: str, card: str) -> None:
    """A second admit and three ticks under torch.profiler: the device's
    busy share of each and the device ops that take the most time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def self_device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    for label, fn in (("admit", lambda: eng.admit(make_reqs())),
                      ("3 ticks", lambda: [eng.tick() for _ in range(3)])):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # the device timeline's mirrors of the moe.* ranges are spans, not
        # work: left out
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                and not e.name.startswith("moe.")]
        if not kern:
            raise AssertionError(f"{arch} {label}: the profile holds no "
                                 f"device op")
        busy_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
        top = sorted((e for e in prof.key_averages()
                      if not e.key.startswith("moe.")),
                     key=self_device_us, reverse=True)
        print(f"[profile serve] {arch} {label}: wall {wall_ms:.3f} ms "
              f"profiled, {len(kern)} device ops, device busy "
              f"{busy_ms:.3f} ms = {busy_ms / wall_ms:.4f} of the wall "
              f"({card})", flush=True)
        # the six costliest device ops, then the port's kernels among the
        # rest (attention's share of the admit)
        ours = [e for e in top if any(k in e.key for k in PORT_KERNELS)]
        for e in top[:6] + [e for e in ours if e not in top[:6]]:
            print(f"[profile serve] {arch} {label}:   "
                  f"{self_device_us(e) / 1e3:.3f} ms in {e.count} calls of "
                  f"{e.key[:90]}", flush=True)
        for e in ours:
            print(f"[profile serve] {arch} {label}: the port's "
                  f"{e.key[:60]}: {self_device_us(e) / 1e3:.3f} ms, "
                  f"{self_device_us(e) / 1e3 / busy_ms:.4f} of the device "
                  f"time, {self_device_us(e) / 1e3 / wall_ms:.4f} of the "
                  f"wall", flush=True)
        for stage, (host_ms, dev_ms, n_ops, calls) in moe_stages(
                prof).items():
            print(f"[profile serve] {arch} {label}: {stage}: {calls} calls, "
                  f"host {host_ms:.3f} ms, device {dev_ms:.3f} ms in "
                  f"{n_ops} ops = {dev_ms / busy_ms:.4f} of the device time",
                  flush=True)


def moe_stages(prof) -> dict:
    """Each ``moe.*`` label of a profile (dispatch, experts, combine):
    host ms in its ranges, and the device ms and count of the device ops
    that start inside its mirrored spans on the device's timeline."""
    import bisect
    from torch.autograd import DeviceType
    evs = list(prof.profiler.kineto_results.events())
    ops = sorted((e.start_ns(), e.duration_ns()) for e in device_ops(prof))
    starts = [t for t, _ in ops]
    out: dict = {}
    for e in evs:
        if not e.name().startswith("moe."):
            continue
        host, dev, n, calls = out.get(e.name(), (0.0, 0.0, 0, 0))
        if e.device_type() == DeviceType.CUDA:
            lo = bisect.bisect_left(starts, e.start_ns())
            hi = bisect.bisect_right(starts, e.end_ns())
            dev += sum(d for _, d in ops[lo:hi]) / 1e6
            n += hi - lo
        else:
            host += e.duration_ns() / 1e6
            calls += 1
        out[e.name()] = (host, dev, n, calls)
    return out


# phase 4s's qwen2-vl-72b: full width, 20 of its 80 layers (145 GB whole)
VLM_SERVE_LAYERS = 20


def phase_serve(card: str) -> dict:
    return {arch: serve_full(arch, card) for arch in ("hymba-1.5b",
                                                       "rwkv6-7b")}


def phase_serve_families(card: str) -> dict:
    """Phase 4s for the moe, vlm and encdec families: moonshot whole (a
    profiled admit and three ticks), qwen2-vl at full width cut to
    ``VLM_SERVE_LAYERS`` layers, both through ``ServeEngine``; whisper
    whole through ``prefill_fn``/``decode_fn``."""
    runs = {}
    for arch, cut, profile in (
            ("moonshot-v1-16b-a3b", {}, True),
            ("qwen2-vl-72b", dict(n_layers=VLM_SERVE_LAYERS), False)):
        t0 = time.perf_counter()
        runs[arch] = serve_full(arch, card, profile, **cut)
        print(f"[time] 4s {arch}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    t0 = time.perf_counter()
    runs["whisper-large-v3"] = serve_encdec(card)
    print(f"[time] 4s whisper-large-v3: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return runs


# ------------------------------------------------ phases 4z, 4s: the families
# Phase 4z's full-width cuts of the model zoo's families in float32: (depth,
# batch, the inputs); the CPU side runs in the worker processes
# (``_cpu_job("zoo <arch>")``) on the same weights and inputs.
ZOO_FAMILIES = {
    # hybrid: attention beside the SSD scan in each layer
    "hymba-1.5b": dict(cut=dict(n_layers=2), B=2, S=2048),
    # ssm: the rwkv6 scan in each layer
    "rwkv6-7b": dict(cut=dict(n_layers=2), B=2, S=1024),
    # the leading dense layer and one MoE layer (64 experts, top 6)
    "moonshot-v1-16b-a3b": dict(cut=dict(n_layers=2), B=2, S=1024),
    # 2 encoder and 2 decoder layers over 1,500 frames, 64 decoder tokens
    "whisper-large-v3": dict(cut=dict(n_layers=2, encoder_layers=2), B=2,
                             S=64, frames=1500),
    # one layer; 256 patch slots of a 16 x 16 grid, then text
    "qwen2-vl-72b": dict(cut=dict(n_layers=1), B=1, S=512, patches=16),
}
ZOO_STEPS = 4
ZOO_MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
ZOO_KERNELS = ("flash_attention", "ssd_scan", "rwkv6_scan")
# values a generator draws (phase 4z's weights), so any number of threads
# draws the same weights
WEIGHT_CHUNK = 1 << 24


def zoo_cfg(arch: str, **over):
    import dataclasses
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(arch), **over)


def seeded_weights(model, seed: int, threads: int = 1):
    """Phase 4z's weights, drawn on the CPU in float32 in the model's own
    scales and fills (``Model._rules``): each chunk of ``WEIGHT_CHUNK``
    values of parameter i from its own generator, seeded from (seed, i,
    chunk), so the card's model (copied chunk by chunk) and the worker's
    get the same weights whatever the threads."""
    import concurrent.futures
    import torch

    def draw(job):
        i, j, n, scale = job
        g = torch.Generator().manual_seed((seed << 40) + (i << 20) + j)
        return torch.empty(n).normal_(generator=g).mul_(scale)

    jobs, dests = [], []
    with torch.no_grad():
        for i, (name, p) in enumerate(model.named_parameters()):
            kind, value = model._rules[name]
            if kind == "fill":
                p.fill_(value)
                continue
            flat = p.view(-1)
            for j, lo in enumerate(range(0, flat.numel(), WEIGHT_CHUNK)):
                n = min(WEIGHT_CHUNK, flat.numel() - lo)
                jobs.append((i, j, n, value))
                dests.append(flat[lo:lo + n])
        with concurrent.futures.ThreadPoolExecutor(threads) as pool:
            for dest, vals in zip(dests, pool.map(draw, jobs)):
                dest.copy_(vals)
    return model


def zoo_inputs(arch: str, cfg) -> tuple[dict, list]:
    """Phase 4z's prefill batch (CPU tensors) and teacher-forced decode
    tokens, from seed 1."""
    import torch
    spec = ZOO_FAMILIES[arch]
    g = torch.Generator().manual_seed(1)
    B, S = spec["B"], spec["S"]
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g)}
    if "frames" in spec:
        batch["frames"] = torch.randn(B, spec["frames"], cfg.d_model,
                                      generator=g)
    if "patches" in spec:
        side = spec["patches"]
        n = side * side
        i = torch.arange(S)
        text = side + i - n
        pos = torch.stack([torch.where(i < n, 0, text),
                           torch.where(i < n, i // side, text),
                           torch.where(i < n, i % side, text)])
        batch["positions3"] = pos[:, None].expand(3, B, S).contiguous()
        batch["patch_embeds"] = torch.randn(B, n, cfg.d_model, generator=g)
    steps = [torch.randint(0, cfg.vocab, (B, 1), generator=g)
             for _ in range(ZOO_STEPS)]
    return batch, steps


def state_arrays(state: dict) -> dict:
    """A decode state as {name: numpy array}: each KV cache's k, v and
    length, the cross K/V, the recurrent states."""
    out = {}
    for key, val in state.items():
        if val is None:
            continue
        if isinstance(val, dict):
            items = val.items()
        elif hasattr(val, "_fields"):
            items = val._asdict().items()
        else:
            items = enumerate(val)
        for name, t in items:
            # a copy: the state is updated in place by the decode steps
            out[f"{key}.{name}"] = t.detach().cpu().clone().numpy()
    return out


def zoo_run(arch: str, device: str, threads: int = 1) -> dict:
    """Phase 4z's run of one family's cut in float32 on ``device``: prefill
    logits, the state after it, four teacher-forced decode steps' logits
    and the state after them, as numpy; on the card also the launches of
    the prefill and the seconds."""
    import torch
    from repro_torch.models.model import build_model
    spec = ZOO_FAMILIES[arch]
    cfg = zoo_cfg(arch, dtype="float32", cache_headroom=ZOO_STEPS,
                  **spec["cut"])
    t0 = time.perf_counter()
    model = seeded_weights(build_model(cfg, device=device), 0, threads)
    batch, steps = zoo_inputs(arch, cfg)
    batch = {k: v.to(device) for k, v in batch.items()}
    if device != "cpu":
        torch.cuda.synchronize()
        reset_launches()
    logits, st = model.prefill_fn(batch)
    out = dict(prefill=logits.cpu().numpy(), state=state_arrays(st))
    if device != "cpu":
        torch.cuda.synchronize()
        out["launches"] = launches()
    out["decode"] = []
    for i, tok in enumerate(steps):
        logits, st = model.decode_fn(st, tok.to(device), spec["S"] + i)
        out["decode"].append(logits.cpu().numpy())
    out["final_state"] = state_arrays(st)
    out["seconds"] = time.perf_counter() - t0
    return out


def zoo_launches(cfg) -> dict:
    """Each zoo kernel's launches in a prefill: ``flash_attention`` once an
    attention layer (encdec: once an encoder layer and twice a decoder
    layer, self and cross), ``ssd_scan`` once a hybrid layer,
    ``rwkv6_scan`` once an ssm layer."""
    n = cfg.n_layers
    fa = {"ssm": 0, "encdec": cfg.encoder_layers + 2 * n}.get(cfg.family, n)
    return {"flash_attention": fa,
            "ssd_scan": n if cfg.family == "hybrid" else 0,
            "rwkv6_scan": n if cfg.family == "ssm" else 0}


def check_launches(label: str, ran: dict, cfg) -> dict:
    """The zoo kernels' launches in ``ran``, raising unless they are
    ``zoo_launches(cfg)``."""
    got = {k: ran[k] for k in ZOO_KERNELS}
    if got != zoo_launches(cfg):
        raise AssertionError(f"{label}: launches {got}, want "
                             f"{zoo_launches(cfg)}")
    return got


def phase_zoo_families(card: str, bg) -> dict:
    """The hybrid, ssm, moe, encdec and vlm families at full width and cut
    depth in float32 with TF32 off: the card (kernels) against the CPU run
    of the worker processes (plain versions), one set of weights."""
    import torch
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = {}
    try:
        for arch, spec in ZOO_FAMILIES.items():
            cfg = zoo_cfg(arch, **spec["cut"])
            got = zoo_run(arch, "cuda", threads=8)
            torch.cuda.empty_cache()
            want = bg.get(f"zoo {arch}")
            e = zoo_close(f"{arch} prefill logits",
                          torch.from_numpy(got["prefill"]),
                          torch.from_numpy(want["prefill"]), ZOO_MODEL_TOL)
            ed = max(zoo_close(f"{arch} decode step {i} logits",
                               torch.from_numpy(a), torch.from_numpy(b),
                               ZOO_MODEL_TOL)
                     for i, (a, b) in enumerate(zip(got["decode"],
                                                    want["decode"])))
            es = 0.0
            for key in ("state", "final_state"):
                if sorted(got[key]) != sorted(want[key]):
                    raise AssertionError(f"{arch} {key}: {sorted(got[key])}"
                                         f" vs {sorted(want[key])}")
                for name in got[key]:
                    es = max(es, zoo_close(
                        f"{arch} {key} {name}",
                        torch.from_numpy(got[key][name]),
                        torch.from_numpy(want[key][name]), ZOO_MODEL_TOL))
            ran = check_launches(f"{arch} prefill", got["launches"], cfg)
            print(f"[zoo model] {arch} d={cfg.d_model} {spec['cut']} "
                  f"B={spec['B']} S={spec['S']} float32: card == cpu within "
                  f"{ZOO_MODEL_TOL}: prefill logits max abs err {e:.3e}, "
                  f"{ZOO_STEPS} teacher-forced decode steps {ed:.3e}, "
                  f"states ({', '.join(sorted(got['final_state']))}) "
                  f"{es:.3e}; launches {ran}; card "
                  f"{got['seconds']:.1f} s, cpu worker "
                  f"{want['seconds']:.1f} s ({card})", flush=True)
            result[arch] = ran
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return result


def serve_encdec(card: str) -> dict:
    """whisper-large-v3 whole in bfloat16 on the card through ``prefill_fn``
    and ``decode_fn``, as the reference's tests drive it: 4 streams of
    1,500 frames and 4 decoder prompt tokens, 16 greedy tokens each."""
    import torch
    from repro_torch.models.model import build_model
    arch, B, n_frames, prompt, max_new = "whisper-large-v3", 4, 1500, 4, 16
    cfg = zoo_cfg(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    g = torch.Generator(device="cuda").manual_seed(1)
    frames = torch.randn(B, n_frames, cfg.d_model, generator=g,
                         device="cuda")
    toks = torch.randint(1, cfg.vocab, (B, prompt), generator=g,
                         device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    logits, st = model.prefill_fn({"frames": frames, "tokens": toks})
    nxt = torch.argmax(logits, dim=-1)
    out = [nxt.tolist()]
    prefill_s = time.perf_counter() - t0
    ran = launches()
    tick_s = []
    for i in range(max_new - 1):
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{arch}: a logit is not finite at step {i}")
        t0 = time.perf_counter()
        logits, st = model.decode_fn(st, nxt[:, None], prompt + i)
        nxt = torch.argmax(logits, dim=-1)
        out.append(nxt.tolist())
        tick_s.append(time.perf_counter() - t0)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch}: a logit is not finite at the end")
    streams = [[step[b] for step in out] for b in range(B)]
    if any(len(s) != max_new or not all(0 <= t < cfg.vocab for t in s)
           for s in streams):
        raise AssertionError(f"{arch}: {streams}")
    check_launches(f"{arch} prefill", ran, cfg)
    decode_s = sum(tick_s)
    nums = dict(params=n_params, init_s=init_s, prefill_s=prefill_s,
                frames_per_s=B * n_frames / prefill_s,
                decode_ms_per_tick=decode_s / len(tick_s) * 1e3,
                decode_tokens_per_s=B * len(tick_s) / decode_s,
                tokens=B * max_new,
                tokens_per_s=B * max_new / (prefill_s + decode_s),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                admit_launches=ran)
    print(f"[serve] {arch} whole ({n_params} params, bfloat16, "
          f"{cfg.encoder_layers} + {cfg.n_layers} layers): {B} streams x "
          f"{n_frames} frames + {prompt} decoder tokens, {max_new} greedy "
          f"tokens each: prefill {prefill_s:.3f} s "
          f"({nums['frames_per_s']:.1f} frames/s), decode "
          f"{nums['decode_ms_per_tick']:.3f} ms per tick over {len(tick_s)} "
          f"ticks ({nums['decode_tokens_per_s']:.1f} tok/s), "
          f"{nums['tokens']} tokens in {prefill_s + decode_s:.3f} s "
          f"({nums['tokens_per_s']:.1f} tok/s), peak memory "
          f"{nums['peak_gib']:.3f} GiB, weights drawn in {init_s:.2f} s; "
          f"prefill launches {ran} ({card})", flush=True)
    del model, st
    torch.cuda.empty_cache()
    return nums


# --------------------------------------------------------------- phase 5z
def phase_serve_entry() -> None:
    """``launch.serve``'s smoke configs on the card and on the CPU (the same
    request and token counts, each kernel of the path launched), then
    ``--full --prompt-len 2048`` on the card."""
    import torch
    from repro_torch.launch import serve
    keys = ("done", "requests", "tokens")
    for arch, kernels in (("hymba-1.5b", ("flash_attention", "ssd_scan")),
                          ("moonshot-v1-16b-a3b", ("flash_attention",)),
                          ("mixtral-8x22b", ("flash_attention",))):
        reset_launches()
        got = serve.main(["--arch", arch, "--device", "cuda"])
        ran = launches()
        want = serve.main(["--arch", arch, "--device", "cpu"])
        if [got[k] for k in keys] != [want[k] for k in keys]:
            raise AssertionError(f"serve {arch}: cuda {got} != cpu {want}")
        for k in kernels:
            if ran[k] == 0:
                raise AssertionError(f"serve {arch} --device cuda never "
                                     f"launched {k}")
        print(f"[serve entry] {arch} smoke: cuda == cpu "
              f"({[got[k] for k in keys]}; launches {ran})", flush=True)
    for arch in ("hymba-1.5b", "rwkv6-7b", "moonshot-v1-16b-a3b"):
        got = serve.main(["--arch", arch, "--full", "--prompt-len", "2048",
                          "--device", "cuda"])
        if got["done"] != got["requests"]:
            raise AssertionError(f"serve --full {arch}: {got}")
        torch.cuda.empty_cache()


# ------------------------------------------------------------- phase 4t
# one AdamW step at lr 1e-3 without warmup (as tests/train_harness.py)
TRAIN_TC = dict(learning_rate=1e-3, warmup_steps=1)
# the CPU tests' tolerances (tests/train_harness.py): loss, aux and the
# global norm atol = rtol = 1e-4; gradients and first moments per leaf atol
# = 1e-4 * max|cpu|, rtol = 1e-3; second moments twice that; the update p1
# - p0 within 1e-3 lr (plus 4 float32 spacings of p) where the CPU's
# gradient is 10 times its tolerance and 1e3 eps (clipped), so that its
# sign is fixed, and within 2 lr elsewhere
TRAIN_LOSS_TOL = dict(atol=1e-4, rtol=1e-4)
TRAIN_REL_ATOL, TRAIN_RTOL = 1e-4, 1e-3
TRAIN_UPDATE_MARGIN, TRAIN_UPDATE_RTOL = 10.0, 1e-3


def train_inputs(cfg) -> dict:
    """Phase 4t's batch (CPU tensors) from seed 1: 2 rows of 64 tokens,
    the targets the tokens shifted, the first three of row 0 masked; encdec
    64 frames and 8 decoder tokens, vlm 16 patch embeddings and the same
    positions three times."""
    import torch
    g = torch.Generator().manual_seed(1)
    b, s = 2, 64
    if cfg.family == "encdec":
        batch = {"frames": torch.randn(b, s, cfg.d_model, generator=g),
                 "tokens": torch.randint(0, cfg.vocab, (b, 8), generator=g)}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=g)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(b, 16, cfg.d_model, generator=g)
        pos = torch.arange(s)[None].expand(b, s)
        batch["positions3"] = torch.stack([pos] * 3)
    targets = torch.roll(batch["tokens"], -1, dims=1)
    targets[0, :3] = -1
    batch["targets"] = targets
    return batch


def train_run(arch: str, device: str) -> dict:
    """Phase 4t's step of one family's smoke config in float32 on
    ``device``: loss, aux, tokens, every gradient leaf, then the params and
    moments after one AdamW step, as numpy in the reference's layout; on
    the card also the zoo kernels' launches in the loss's forward and
    backward."""
    import dataclasses
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import smoke_config
    from repro_torch.convert import model_params_to_numpy
    from repro_torch.models.model import build_model
    from repro_torch.train import optimizer as topt
    from repro_torch.train.loop import loss_and_grads
    t0 = time.perf_counter()
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    model = seeded_weights(build_model(cfg, device=device), 0)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    batch = {k: v.to(device) for k, v in train_inputs(cfg).items()}
    if device != "cpu":
        torch.cuda.synchronize()
        reset_launches()
    loss, met, grads = loss_and_grads(model, params, batch)
    out = dict(loss=float(loss), aux=float(met["aux"]),
               tokens=float(met["tokens"]),
               grads=model_params_to_numpy(grads))
    if device != "cpu":
        torch.cuda.synchronize()
        out["launches"] = launches()
    out["p0"] = {k: a.copy() for k, a in model_params_to_numpy(params).items()}
    opt = topt.init_opt_state(params)
    _, opt, om = topt.adamw_update(params, grads, opt,
                                   TrainConfig(**TRAIN_TC))
    out.update(params=model_params_to_numpy(params),
               m=model_params_to_numpy(opt.m), v=model_params_to_numpy(opt.v),
               grad_norm=float(om["grad_norm"]),
               seconds=time.perf_counter() - t0)
    return out


def leaves_close(label: str, got: dict, want: dict, *, rel_atol: float,
                 rtol: float, atol: float = 0.0) -> float:
    """Raises unless both trees hold the same leaves and each leaf is
    finite and within atol + rel_atol * max|want| + rtol * |want|; returns
    the largest abs error."""
    import numpy as np
    if sorted(got) != sorted(want):
        raise AssertionError(f"{label}: leaves {sorted(got)} vs "
                             f"{sorted(want)}")
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        if g.shape != w.shape or not np.isfinite(g).all():
            raise AssertionError(f"{label} {k}: {g.shape} vs {w.shape}, or "
                                 f"not finite")
        tol = atol + rel_atol * float(np.abs(w).max(initial=0.0)) \
            + rtol * np.abs(w)
        err = np.abs(g - w)
        if (err > tol).any():
            raise AssertionError(f"{label} {k}: max abs error "
                                 f"{float(err.max())} outside the tolerance")
        worst = max(worst, float(err.max(initial=0.0)))
    return worst


def update_close(label: str, got: dict, want: dict) -> tuple:
    """Raises unless the card's parameters after one AdamW step moved from
    the same ``p0`` as the CPU's by the CPU's update: within
    TRAIN_UPDATE_RTOL * lr (plus 4 float32 spacings of p) where the CPU's
    gradient fixes the update's sign, within 2 lr elsewhere, the former
    most of the elements. Returns (largest error where held tight, how
    many elements were, of how many)."""
    import numpy as np
    from repro_torch.configs.base import TrainConfig
    tc = TrainConfig(**TRAIN_TC)
    lr = tc.learning_rate
    clip = min(1.0, tc.grad_clip / max(want["grad_norm"], 1e-9))
    worst, n_tight, n_all = 0.0, 0, 0
    for k, w1 in want["params"].items():
        p0, g = want["p0"][k], want["grads"][k]
        if not np.array_equal(got["p0"][k], p0):
            raise AssertionError(f"{label} {k}: the card's p0 is not the "
                                 f"CPU's")
        err = np.abs((got["params"][k] - p0) - (w1 - p0))
        tol_g = TRAIN_REL_ATOL * float(np.abs(g).max(initial=0.0)) \
            + TRAIN_RTOL * np.abs(g)
        tight = (np.abs(g) > TRAIN_UPDATE_MARGIN * tol_g) \
            & (np.abs(g) * clip > 1e3 * tc.eps)
        bound = TRAIN_UPDATE_RTOL * lr + 4 * np.spacing(np.abs(p0))
        if not np.isfinite(err).all() or (err[tight] > bound[tight]).any() \
                or (err > 2 * lr).any():
            raise AssertionError(f"{label} {k}: update off by "
                                 f"{float(err.max())}")
        worst = max(worst, float(err[tight].max(initial=0.0)))
        n_tight += int(tight.sum())
        n_all += err.size
    if n_tight <= n_all // 2:
        raise AssertionError(f"{label}: {n_tight} of {n_all} elements with "
                             f"a gradient that fixes the update's sign")
    return worst, n_tight, n_all


def train_launches(cfg) -> dict:
    """The zoo kernels' launches in one loss and gradient: once a layer a
    forward (``zoo_launches``), and ``remat="full"`` runs each block's
    forward a second time in the backward (``torch.utils.checkpoint``); the
    autograd wrappers' own backward launches nothing."""
    forwards = 2 if cfg.remat == "full" else 1
    return {k: forwards * n for k, n in zoo_launches(cfg).items()}


def phase_train_families(card: str, bg) -> dict:
    """One train step of each family's smoke config in float32 with TF32
    off: the card (kernels) against the worker's CPU run (plain versions)
    at the CPU tests' tolerances, the zoo kernels' launches checked."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.registry import smoke_config
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = {}
    try:
        for arch in TRAIN_FAMILIES:
            cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
            got = train_run(arch, "cuda")
            want = bg.get(f"train {arch}")
            for key in ("loss", "aux", "grad_norm"):
                if not np.isclose(got[key], want[key], **TRAIN_LOSS_TOL):
                    raise AssertionError(f"train {arch} {key}: card "
                                         f"{got[key]} cpu {want[key]}")
            if got["tokens"] != want["tokens"]:
                raise AssertionError(f"train {arch}: tokens {got['tokens']}"
                                     f" vs {want['tokens']}")
            errs = dict(
                grads=leaves_close(f"train {arch} grad", got["grads"],
                                   want["grads"], rel_atol=TRAIN_REL_ATOL,
                                   rtol=TRAIN_RTOL),
                m=leaves_close(f"train {arch} m", got["m"], want["m"],
                               rel_atol=TRAIN_REL_ATOL, rtol=TRAIN_RTOL),
                v=leaves_close(f"train {arch} v", got["v"], want["v"],
                               rel_atol=2 * TRAIN_REL_ATOL,
                               rtol=2 * TRAIN_RTOL))
            errs["update"], n_tight, n_all = update_close(
                f"train {arch} params", got, want)
            ran = {k: got["launches"][k] for k in ZOO_KERNELS}
            if ran != train_launches(cfg):
                raise AssertionError(f"train {arch}: launches {ran}, want "
                                     f"{train_launches(cfg)}")
            print(f"[train] {arch} smoke float32 (layers {cfg.n_layers}, "
                  f"remat {cfg.remat}): card == cpu: loss "
                  f"{got['loss']:.6f} vs {want['loss']:.6f}, aux "
                  f"{got['aux']:.6f} vs {want['aux']:.6f}, grad norm "
                  f"{got['grad_norm']:.6f} vs {want['grad_norm']:.6f}; max "
                  f"abs err grads {errs['grads']:.3e}, m {errs['m']:.3e}, "
                  f"v {errs['v']:.3e}, AdamW update {errs['update']:.3e} "
                  f"(on the {n_tight} of {n_all} elements whose gradient "
                  f"fixes its sign); launches {ran} (forward and "
                  f"remat recompute); card {got['seconds']:.1f} s, cpu "
                  f"worker {want['seconds']:.1f} s ({card})", flush=True)
            result[arch] = ran
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return result


def profile_train_step(step, label: str, card: str) -> dict:
    """One train step under torch.profiler: wall ms, device ops, the
    device's busy share of the wall and the six costliest device ops by
    name (read from the raw trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = device_ops(prof)
    if not kern:
        raise AssertionError(f"{label}: the profile holds no device op")
    by_name: dict = {}
    for e in kern:
        ns, n = by_name.get(e.name(), (0, 0))
        by_name[e.name()] = (ns + e.duration_ns(), n + 1)
    busy_ms = sum(ns for ns, _ in by_name.values()) / 1e6
    print(f"[train full] {label} profiled step: wall {wall_ms:.3f} ms, "
          f"{len(kern)} device ops, device busy {busy_ms:.3f} ms = "
          f"{busy_ms / wall_ms:.4f} of the wall ({card})", flush=True)
    for name, (ns, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"[train full] {label}:   {ns / 1e6:.3f} ms "
              f"({ns / 1e6 / busy_ms:.4f} of busy) in {n} calls of "
              f"{name[:90]}", flush=True)
    return dict(wall_ms=wall_ms, busy=busy_ms / wall_ms, ops=len(kern))


def train_full(arch: str, cut: dict, card: str) -> dict:
    """``arch`` at full width (``cut`` its depth) in bfloat16 on the card:
    random weights from a card generator, batches of the synthetic stream
    (B 4 x S 2048), remat "full"; one warm-up step, then ``TRAIN_TIMED``
    timed steps and one profiled. Prints tokens/s, ms a step, peak memory
    and the zoo kernels' launches a step."""
    import dataclasses
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data import pipeline as dp
    from repro_torch.models.model import build_model
    from repro_torch.train import optimizer as topt
    from repro_torch.train.loop import make_train_step
    cfg = dataclasses.replace(get_config(arch), **cut)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    params = dict(model.named_parameters())
    opt = topt.init_opt_state(params)
    step = make_train_step(model, TrainConfig(learning_rate=3e-4,
                                              warmup_steps=2))
    dcfg = dp.DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                         global_batch=TRAIN_B)
    batches = [{k: v.to("cuda") for k, v in
                dp.batch_for_shard(dcfg, i, 0, 1).items()}
               for i in range(TRAIN_TIMED + 2)]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state = [params, opt]

    def run(i):
        state[0], state[1], m = step(state[0], state[1], batches[i])
        return m

    losses = [float(run(0)["loss"])]               # the warm-up step
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for i in range(1, TRAIN_TIMED + 1):
        losses.append(float(run(i)["loss"]))
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_TIMED
    ran = {k: v // TRAIN_TIMED for k, v in launches().items()
           if k in ZOO_KERNELS}
    if ran != train_launches(cfg):
        raise AssertionError(f"train full {arch}: launches a step {ran}, "
                             f"want {train_launches(cfg)}")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"train full {arch}: losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    tok = TRAIN_B * TRAIN_S
    print(f"[train full] {arch} ({n_params} params, bfloat16, {cut or 'whole'}"
          f", remat {cfg.remat}): B {TRAIN_B} x S {TRAIN_S}, "
          f"{dt * 1e3:.3f} ms a step over {TRAIN_TIMED} steps after one "
          f"warm-up, {tok / dt:.1f} tokens/s, peak memory {peak:.3f} GiB, "
          f"losses {[round(x, 4) for x in losses]}, launches a step {ran}, "
          f"weights and batches made in {init_s:.2f} s ({card})", flush=True)
    prof = profile_train_step(lambda: run(TRAIN_TIMED + 1), arch, card)
    del model, params, state, opt, step, batches
    torch.cuda.empty_cache()
    return dict(ms=dt * 1e3, tokens_per_s=tok / dt, peak_gib=peak,
                launches=ran, **prof)


def phase_train_entry(card: str) -> dict:
    """``python -m repro_torch.launch.train --arch smollm-135m --full
    --steps 30`` on the card (its ``main``, as phase 5z calls the serve
    launcher's): the mean loss of the last 10 steps below the first 10's,
    ``flash_attention`` launched."""
    from repro_torch.launch import train as launch_train
    reset_launches()
    t0 = time.perf_counter()
    got = launch_train.main(["--arch", "smollm-135m", "--full", "--steps",
                             "30"])
    took = time.perf_counter() - t0
    ran = launches()
    if not got["last10"] < got["first10"]:
        raise AssertionError(f"launch.train: the loss did not fall: {got}")
    if ran["flash_attention"] == 0:
        raise AssertionError("launch.train never launched flash_attention")
    print(f"[train entry] launch.train --arch smollm-135m --full --steps 30 "
          f"on the card: first-10 loss {got['first10']:.4f} -> last-10 "
          f"{got['last10']:.4f}; {took:.1f} s, launches {ran} ({card})",
          flush=True)
    return dict(first10=got["first10"], last10=got["last10"], seconds=took)


def train_schemes(card: str) -> dict:
    """``TRI_ARCH`` whole at full width in ``TRI_DTYPE`` (TF32 off), B
    ``TRI_B`` x S ``TRI_S``, remat "full": one loss-and-gradient step (the
    forward, the backward, no optimizer) in the ``rect`` causal scheme and
    one in ``tri``, on the same weights and batch, each after a warm-up.
    The forward is ``flash_attention`` under both (its kernel skips the
    tiles outside the band either way); the backward's recompute
    (``layers.chunked_attention``) visits every key chunk under ``rect``
    and the band's under ``tri``, counted here through ``layers._online``.
    The losses must be equal and each gradient leaf within ``TRI_TOL``."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data import pipeline as dp
    from repro_torch.models import layers
    from repro_torch.models.model import build_model
    from repro_torch.train.loop import loss_and_grads
    cfg = dataclasses.replace(get_config(TRI_ARCH), dtype=TRI_DTYPE)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build_model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    batch = {k: v.to("cuda") for k, v in dp.batch_for_shard(
        dp.DataConfig(vocab=cfg.vocab, seq_len=TRI_S, global_batch=TRI_B),
        0, 0, 1).items()}
    real, visits = layers._online, [0]

    def counted(qr, q_pos, chunks, *args):
        chunks = list(chunks)
        visits[0] += qr.shape[1] * len(chunks)
        return real(qr, q_pos, chunks, *args)

    out = {}
    try:
        layers._online = counted
        for scheme in ("rect", "tri"):
            model.cfg = dataclasses.replace(cfg, causal_scheme=scheme)
            loss_and_grads(model, params, batch)          # the warm-up
            torch.cuda.synchronize()
            reset_launches()
            visits[0] = 0
            t0 = time.perf_counter()
            loss, _, grads = loss_and_grads(model, params, batch)
            torch.cuda.synchronize()
            out[scheme] = dict(ms=(time.perf_counter() - t0) * 1e3,
                               loss=loss, grads=grads,
                               visits=visits[0] / cfg.n_layers,
                               launches=launches()["flash_attention"])
    finally:
        layers._online = real
        model.cfg = cfg
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
        torch.backends.cudnn.allow_tf32 = tf32[1]
    rect, tri = out["rect"], out["tri"]
    worst, ratio, off = 0.0, 0.0, []
    for k, want in rect["grads"].items():
        got, want = tri["grads"][k].float(), want.float()
        err = (got - want).abs()
        scale = want.abs().max() + want.abs()
        if not bool(torch.isfinite(got).all()) or \
                bool((err > TRI_TOL + TRI_TOL * want.abs()).any()):
            off.append(k)
        worst = max(worst, float(err.max()))
        ratio = max(ratio, float((err / scale.clamp_min(1e-30)).max()))
    print(f"[train schemes] {TRI_ARCH} whole, {TRI_DTYPE} (TF32 off), B "
          f"{TRI_B} x S {TRI_S}, window {cfg.window}, chunks "
          f"{cfg.attn_chunk_q} / {cfg.attn_chunk_kv}: loss and gradients "
          f"rect {rect['ms']:.3f} ms, tri {tri['ms']:.3f} ms "
          f"({tri['ms'] / rect['ms']:.4f}); key-chunk visits a layer "
          f"{rect['visits']:g} and {tri['visits']:g}; flash_attention "
          f"launches {rect['launches']} and {tri['launches']} a step; loss "
          f"{float(rect['loss']):.6f} and {float(tri['loss']):.6f}; "
          f"gradients' largest abs difference {worst:.3e} (tolerance "
          f"{TRI_TOL} + {TRI_TOL} |g|), largest |diff| / (max|g| + |g|) "
          f"{ratio:.3e} ({card})", flush=True)
    if not torch.equal(rect["loss"], tri["loss"]) or \
            not bool(torch.isfinite(rect["loss"])):
        raise AssertionError(f"tri: loss {float(tri['loss'])} against rect "
                             f"{float(rect['loss'])}")
    if off:
        raise AssertionError(f"tri: gradients {off} outside {TRI_TOL}")
    want_launches = 2 * cfg.n_layers               # remat: two forwards
    if rect["launches"] != want_launches or tri["launches"] != want_launches:
        raise AssertionError(f"tri: flash_attention launches "
                             f"{rect['launches']} and {tri['launches']}, "
                             f"want {want_launches}")
    if (rect["visits"], tri["visits"]) != (8, 5):
        raise AssertionError(f"key-chunk visits a layer {rect['visits']} "
                             f"(rect) and {tri['visits']} (tri), want 8, 5")
    result = dict(rect_ms=rect["ms"], tri_ms=tri["ms"], max_abs_err=worst,
                  visits=(rect["visits"], tri["visits"]),
                  launches=tri["launches"])
    del model, params, out, rect, tri
    torch.cuda.empty_cache()
    return result


def phase_train(card: str, bg) -> dict:
    """Phase 4t: the families' step card against CPU, hymba-1.5b whole and
    rwkv6-7b at full width cut to 8 layers, the causal schemes at S 4,096,
    then the entry point."""
    out = {"families": timed("4t families", phase_train_families, card, bg)}
    for arch, cut in TRAIN_FULL:
        out[arch] = timed(f"4t {arch}", train_full, arch, cut, card)
    out["schemes"] = timed("4t schemes", train_schemes, card)
    out["entry"] = timed("4t entry", phase_train_entry, card)
    return out


# ------------------------------------------------- phase 4r: the roofline
def roofline_record(arch: str, mode: str) -> dict:
    """The dry run's record of a step an earlier phase times, counted on
    ``meta`` with a one-chip mesh: ``mode`` "train" (``TRAIN_FULL``'s cut,
    B ``TRAIN_B`` x S ``TRAIN_S``), "tri" (the step of
    :func:`train_schemes` in the ``tri`` scheme, in ``TRI_DTYPE``) or
    "prefill" (an admit of 4 x 2048, the
    cache's 16 slots of headroom). Run in a worker process
    (``_cpu_job("roofline <arch> <mode>")``)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    if mode == "train":
        S, B, over = TRAIN_S, TRAIN_B, dict(TRAIN_FULL)[arch]
    elif mode == "tri":
        S, B, over = TRI_S, TRI_B, dict(causal_scheme="tri", dtype=TRI_DTYPE)
    else:
        S, B, over = 2048, 4, dict(cache_headroom=16)
    step = "train" if mode == "tri" else mode
    t0 = time.perf_counter()
    rec = dryrun.run_cell(arch, ShapeConfig(step, S, B, step), "single",
                          overrides=over or None, mesh=ONE_CHIP,
                          verbose=False)
    rec["count_s"] = time.perf_counter() - t0
    rec["cut"], rec["B"], rec["S"] = over, B, S
    return rec


def step_bound(rec: dict, mode: str, measured_ms: float, card: str) -> dict:
    """A timed step against its dry-run record: the compute and memory
    terms on the H100's constants, the bound (the larger), the useful share
    of the counted work, measured / bound and model_flops / peak /
    measured. A measured step shorter than its bound means the count
    reckons work that does not run: the phase fails."""
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16
    arch, r = rec["arch"], rec["roofline"]
    bound_ms = max(r["t_compute_s"], r["t_memory_s"]) * 1e3
    mfu = r["model_flops"] / PEAK_FLOPS_BF16 / (measured_ms / 1e3)
    print(f"[roofline] {arch} {mode} ({rec['cut'] or 'whole'}, B {rec['B']} "
          f"x S {rec['S']}, {(rec['cut'] or {}).get('dtype', 'bfloat16')}): "
          f"counted {rec['count']['flops']} FLOPs "
          f"and {rec['count']['dot_bytes']} dot bytes on meta in "
          f"{rec['count_s']:.1f} s (a worker process); t_compute "
          f"{r['t_compute_s'] * 1e3:.3f} ms, t_memory "
          f"{r['t_memory_s'] * 1e3:.3f} ms, bound {bound_ms:.3f} ms "
          f"({r['bottleneck']}), useful_ratio {r['useful_ratio']:.4f}; "
          f"measured {measured_ms:.3f} ms = {measured_ms / bound_ms:.3f} x "
          f"the bound; model_flops / peak / measured {mfu:.4f} (bounds from "
          f"counts and H100 datasheet constants; measured on {card})",
          flush=True)
    if measured_ms < bound_ms:
        raise AssertionError(f"{arch} {mode}: measured {measured_ms:.3f} ms "
                             f"beats its bound {bound_ms:.3f} ms")
    return dict(bound_ms=bound_ms, measured_ms=measured_ms, mfu=mfu,
                useful_ratio=r["useful_ratio"], t_compute_s=r["t_compute_s"],
                t_memory_s=r["t_memory_s"])


def phase_roofline(card: str, trained: dict, admitted: dict,
                   bg: Background) -> dict:
    """Phase 4r: the dry run's bounds of the steps phases 4t and 4s timed
    (:func:`step_bound`, the counts taken in the worker processes; the tri
    step of :func:`train_schemes` from its own count); then ``launch/dryrun.py`` for smollm-135m's
    train_4k on the two-pod mesh into a temporary directory, whose record
    ``simulate workload`` runs on the card and on the CPU: equal lines, the
    all-reduce bytes nonzero, ``maxmin_rates`` launched."""
    import tempfile
    from repro_torch.launch import dryrun, simulate
    out = {}
    for arch, _ in TRAIN_FULL:
        out[f"{arch} train"] = step_bound(bg.get(f"roofline {arch} train"),
                                          "train", trained[arch]["ms"], card)
    # the tri step of phase 4t: its loss and gradients, no optimizer, so
    # the step's count (which adds no product for AdamW) bounds it
    out[f"{TRI_ARCH} tri"] = step_bound(bg.get(f"roofline {TRI_ARCH} tri"),
                                        "train (tri)",
                                        trained["schemes"]["tri_ms"], card)
    for arch in ROOFLINE_ADMITS:
        out[f"{arch} admit"] = step_bound(
            bg.get(f"roofline {arch} prefill"), "prefill",
            admitted[arch]["prefill_s"] * 1e3, card)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        dryrun.main(["--arch", "smollm-135m", "--shape", "train_4k",
                     "--mesh", "multi", "--results", tmp])
        took = time.perf_counter() - t0
        with open(os.path.join(tmp, "smollm-135m__train_4k__multi.json")) as f:
            rec = json.load(f)
        if rec["status"] != "ok":
            raise AssertionError(f"dryrun: {rec.get('error')}")
        kinds = rec["roofline"]["coll_by_kind"]
        if not kinds["all-reduce"] > 0:
            raise AssertionError(f"dryrun multi: no all-reduce bytes {kinds}")
        reset_launches()
        lines = {"cuda": simulate.main(["workload", "--results", tmp,
                                        "--device", "cuda"])}
        ran = launches()
        lines["cpu"] = simulate.main(["workload", "--results", tmp,
                                      "--device", "cpu"])
    if lines["cuda"] != lines["cpu"] or len(lines["cuda"]) != 1:
        raise AssertionError(f"simulate workload on the dry run: {lines}")
    if ran["maxmin_rates"] == 0:
        raise AssertionError("simulate workload never launched maxmin_rates")
    print(f"[roofline] dryrun smollm-135m train_4k multi in {took:.1f} s: "
          f"collectives {kinds}; simulate workload --device cuda == --device "
          f"cpu; launches {ran} ({card})", flush=True)
    out["workload"] = dict(lines=lines["cuda"], launches=ran)
    return out


def ptxas_lines(log: str, kernels) -> None:
    """``ptxas -v``'s registers, shared memory and spills of each instance
    of the named kernels (the lines after each "Compiling entry function"
    that names one, up to the next)."""
    blocks = log.split("Compiling entry function")[1:]
    for name in kernels:
        found = [b for b in blocks if name in b.split("\n", 1)[0]]
        if not found:
            raise AssertionError(f"ptxas compiled no {name}")
        for b in found:
            head, *rest = b.splitlines()
            facts = [x.split("info    :")[-1].strip() for x in rest
                     if "Used" in x or "spill" in x]
            print(f"[build] {name} {head.split(chr(39))[1]}: "
                  f"{'; '.join(facts)}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    from repro_torch.kernels import event_select as es
    from repro_torch.kernels import ref

    card = smi()
    print(f"[device] {card}; torch {torch.__version__}; CUDA "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}",
          flush=True)
    bg = Background()
    try:
        return run_phases(card, es, ref, bg)
    finally:
        bg.close()


def timed(label: str, fn, *args, **kw):
    """``fn(*args, **kw)``, printing its seconds and the script's so far."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    now = time.perf_counter()
    print(f"[time] {label}: {now - t0:.1f} s ({now - T_START:.1f} s since "
          f"the start)", flush=True)
    return out


def run_phases(card: str, es, ref, bg: Background) -> int:
    import torch
    from repro_torch.kernels import build
    timed("phase 2 build", build.build_all)
    for name, info in build.build_info.items():
        print(f"[build] {name}: {info['seconds']:.2f} s -> {info['path']}",
              flush=True)
        print("\n".join(f"[build] {line}" for line in info["log"].splitlines()
                        if any(k in line for k in ("registers", "Compiling",
                                                   "spill"))), flush=True)
    ptxas_lines(build.build_info["event_select"]["log"],
                ("group_by_kind_kernel", "ring_slots_kernel",
                 "route_rank_kernel"))
    lib = build.library("rwkv6_scan")
    print(f"[build] rwkv6_tc_kernel: {lib.gla_tc_smem_bytes()} B of dynamic "
          f"shared memory, {lib.gla_tc_blocks_per_sm()} CTAs per SM",
          flush=True)
    for dk in (16, 64):
        print(f"[build] ssd_tc_kernel at dk {dk}: "
              f"{lib.gla_ssd_smem_bytes(dk)} B of dynamic shared memory, "
              f"{lib.gla_ssd_blocks_per_sm(dk)} CTAs per SM", flush=True)
    print(f"[build] maxmin_warp_kernel: "
          f"{build.library('bandwidth_share').maxmin_warp_blocks_per_sm()} "
          f"CTAs per SM (8 lanes each)", flush=True)
    timings = timed("phase 3 kernels", phase_kernels, es, ref)
    timings["maxmin_rates"] = timed("phase 3 maxmin", phase_maxmin,
                                    torch.Generator().manual_seed(1))
    # before phase 4's profiles: after a long profiled run, a short one
    # records no device op (device_ms needs them)
    timings.update(timed("phase 3z", phase_zoo_kernels))
    main_run = timed("phase 4", phase_main_path, card, bg)
    fused_run = timed("phase 4b", phase_fused_path, card, main_run)
    timed("phase 4c", phase_workload, card, bg)
    timed("profile stitched", phase_profile, card, fused=False)
    timed("profile fused", phase_profile, card, fused=True)
    timed("phase 5", phase_entry_point, bg)
    scen = timed("phase 4e", phase_scenarios, card, bg)
    timed("phase 4g", phase_ensemble, card, *scen.pop("failures_run"),
          scen["failures"]["stitched"], bg)
    timed("phase 4f", phase_host_layer, card, main_run)
    timed("phase 4h", phase_distributed, card, main_run, bg)
    timed("phase 4z", phase_zoo_families, card, bg)
    served = timed("phase 4s", phase_serve, card)
    families = timed("phase 4s families", phase_serve_families, card)
    timed("phase 5z", phase_serve_entry)
    trained = timed("phase 4t", phase_train, card, bg)
    timed("phase 4r", phase_roofline, card, trained, {**served, **families},
          bg)

    # launches on each kernel's own path: the stitched run for the four
    # stitched hooks and maxmin_rates, the fused run for fused_select and
    # ring_slots, the full-depth serve admits for the model zoo's kernels
    zoo = {"flash_attention": "hymba-1.5b", "ssd_scan": "hymba-1.5b",
           "rwkv6_scan": "rwkv6-7b"}
    kernels = []
    for name, t in timings.items():
        if name in zoo:
            n = served[zoo[name]]["admit_launches"][name]
        else:
            run = (fused_run if name in ("fused_select", "ring_slots")
                   else main_run)
            n = run["launches"][name]
        kernels.append(dict(name=name, route="cuda", **KERNELS[name],
                            launches=n, **t))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
