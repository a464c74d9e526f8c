#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port: the quickest proof that it runs.

    python3 chip_smoke.py

Needs one CUDA card (fails without one, and fails when run outside a
checkout of the repository). Phases, each of which raises on failure:

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
   with head 40, and refusing a q that is not 16-byte aligned; then each
   timed (CUDA events and device time) against the
   plain version, the bound and, for attention,
   ``scaled_dot_product_attention`` with the same mask, with the achieved
   TFLOP/s and share of the bound;
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
   with 1 and 4 agents, and with 4 agents under ``--fused-select``, under
   ``--insert-mode ref --merge-mode dense`` and under ``--adaptive-exec``,
   each equal to ``--device cpu`` and to the stitched run;
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
4z. the model path at full width and 2 layers: hymba-1.5b (B 2, S 2048) and
   rwkv6-7b (B 2, S 1024) in float32 with TF32 off, one set of random
   weights on the card (the kernels) and on the CPU (the plain versions):
   prefill logits, the decode state and four teacher-forced decode steps'
   logits agree; each kernel of the model launched once per layer;
4s. the serve path at full width and depth: ``ServeEngine`` on the card in
   bfloat16 with random weights, hymba-1.5b then rwkv6-7b, 4 requests of
   2048 tokens in 4 slots, 16 new tokens each: 32 launches of
   ``flash_attention`` and ``ssd_scan`` (hymba) or ``rwkv6_scan`` (rwkv6)
   at the admit, every logit finite, every token in the vocabulary, every
   request done; prefill seconds, decode ms per tick, tokens per second
   and peak memory; then a second admit and three ticks under
   torch.profiler (device busy share, the costliest device ops and the
   port's kernels);
5z. the serve entry point, ``repro_torch.launch.serve --arch hymba-1.5b``
   (smoke config) on the card and on the CPU with the same request and
   token counts, then ``--full --prompt-len 2048`` on the card for both
   arches;
6. a JSON line of the kernels, then the card's name and power limit, then
   the result line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

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

    def check(B, F, L, edge=None):
        inc, bw, act = maxmin_inputs(g, B, F, L, edge)
        order = ref.flow_order(F, L, B)
        bs.reset_launches()
        got = bs.maxmin_rates(inc, bw, act, order)
        ran = {k: n for k, n in bs.KERNELS.items() if n}
        if ran != {maxmin_kernel_name(F, L): 1}:
            raise AssertionError(f"maxmin_rates {(B, F, L)} ran {ran}")
        want = ref.maxmin_rates(inc, bw, act)
        max_err(got.view(torch.int32), want.view(torch.int32))
        print(f"[kernels] maxmin_rates B={B} F={F} L={L} head={order.head}"
              f" chains={order.chains} tail_lanes={order.tail_lanes}"
              f" trailing={order.trailing}"
              f"{' ' + edge if edge else ''} ({next(iter(ran))}): equal",
              flush=True)
        return inc, bw, act

    # tiered_grid's (32, 4) at 2048, 8 and 1 lanes, the warp kernel's edges
    # (32 flows or links, one flow, one link) and the block kernel's side
    # (33 flows; the 64-pod workload's (128, 64))
    cases = [(2048, 32, 4), (8, 32, 4), (1, 32, 4), (64, 32, 32),
             (64, 1, 32), (64, 32, 1), (64, 33, 4), (64, 32, 33),
             (256, 128, 64), (1, 128, 64), (1, 60, 8), (1, 1, 1), (3, 1, 4)]
    for F, ranges in sorted(ref._UNBATCHED_ORDER.items()):
        cases += [(1, F, L) for lo, hi, _ in ranges for L in {lo, hi}]
    for B, F, L in cases:
        check(B, F, L)
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
        packed = bs._pack_order(order, F, lib.maxmin_max_order_blocks())
        o = torch.empty((B, F), dtype=torch.float32, device=inc.device)
        return lib.launch_maxmin_rates(
            inc.data_ptr(), bw.data_ptr(), act.data_ptr(), o.data_ptr(), B,
            F, L, order.head, packed, order.chains, order.tail_lanes,
            order.trailing, torch.cuda.current_stream().cuda_stream)

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
            *ptrs, B, F, L, 0, 0, 1, 1, 0, stream),
        "whole: bs.maxmin_rates": lambda: bs.maxmin_rates(inc, bw, act,
                                                          order),
        "whole: the call as before": as_before,
        "whole: ops.maxmin_rates, the engine's": lambda: ops.maxmin_rates(
            inc, bw, act),
    }
    for what, fn in pieces.items():
        print(f"[kernels] maxmin_rates call path (2048, 32, 4): {what}: "
              f"{host_us(fn):.3f} us host", flush=True)


# --------------------------------------------------------------- phase 4c
def phase_workload(card: str) -> dict:
    """The workload bridge at full width: a 64-pod cell (128 flow slots
    over 64 WAN links, one agent) on the card and on the CPU; then the
    ``simulate workload`` entry point on both devices."""
    import tempfile
    import torch
    from repro_torch.core import Engine
    from repro_torch.core import monitoring as mon
    from repro_torch.core import workload as wl
    from repro_torch.launch import simulate

    cell = wl.CellModel(n_pods=64, t_compute_s=0.05, dcn_bytes_per_pod=2e9,
                        n_steps=1)
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
    t0 = time.perf_counter()
    st_cpu = Engine(*scen, device="cpu").run_local(max_windows=200_000)
    want = wl.summarize(cell, st_cpu)
    state_equal(st, st_cpu)
    if got != want:
        raise AssertionError(f"64 pods: cuda {got} != cpu {want}")
    print(f"[workload] 64 pods: cuda state == cpu state, same result "
          f"(cpu {time.perf_counter() - t0:.1f} s)", flush=True)

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
def state_equal(a, b) -> None:
    """Byte equality of two port states (floats by bit pattern)."""
    from repro_torch.convert import state_to_numpy
    sa, sb = state_to_numpy(a), state_to_numpy(b)

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
    return st, ran, dict(windows=windows, events=events, wall=wall)


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


def phase_main_path(card: str) -> dict:
    from repro_torch.core import components as comps
    from repro_torch.core import Engine, merged_engine_trace, run_sequential

    world, own, init_ev, spec = tiered_grid(comps).build(**tiered_build_kw())
    st, ran, nums = run_tiered(card, fused=False)
    missing = [k for k in ("select_events", "group_by_kind", "trace_rank",
                           "route_rank") if ran[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    if ran["group_by_kind"] != nums["windows"]:
        raise AssertionError(f"group_by_kind launched {ran['group_by_kind']}"
                             f" times in {nums['windows']} windows")

    t0 = time.perf_counter()
    st_cpu = Engine(world, own, init_ev, spec, trace_cap=65536,
                    device="cpu").run_local()
    print(f"[tiered_grid] cpu reference run: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    state_equal(st, st_cpu)
    print("[tiered_grid] cuda state == cpu state (trace, counters, world, "
          "pool, ring cursors)", flush=True)

    t0 = time.perf_counter()
    _w, _c, want = run_sequential(world, own, init_ev, spec,
                                  max_events=1_000_000)
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
          f"events, {ties} rows share (time, seq) with another; "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    return dict(launches=ran, state=st, oracle=sorted(want), **nums)


def phase_profile(card: str, fused: bool, start: int = 150,
                  n: int = 20) -> None:
    """Where a window's time goes on a path: ``n`` windows of the tiered
    Grid from window ``start`` on, first unprofiled, then under
    torch.profiler (device busy share, kernels per window, host time of the
    engine's labelled steps)."""
    import torch
    from torch.autograd import DeviceType
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
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        raise AssertionError(f"{tag}: the profile holds no device op")
    busy_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3 / n
    print(f"{tag} windows {start}..{start + 2 * n}: {plain_ms:.3f} "
          f"ms/window unprofiled, {prof_ms:.3f} ms/window profiled; "
          f"{len(kern) / n:.1f} device ops/window, device busy "
          f"{busy_ms:.3f} ms/window = {busy_ms / prof_ms:.4f} of the "
          f"profiled wall ({card})", flush=True)
    for e in sorted(prof.key_averages(), key=lambda e: e.key):
        if e.key.startswith(("window.", "execute.")):
            print(f"{tag} {e.key}: host {e.cpu_time_total / 1e3 / n:.3f} "
                  f"ms/window, {e.count / n:.2f} calls/window", flush=True)


def phase_entry_point() -> dict:
    from repro_torch.launch import simulate
    ran, lines = {}, {}
    runs = {"1": ["--agents", "1"], "4": ["--agents", "4"],
            "4 fused": ["--agents", "4", "--fused-select"],
            "4 ref dense": ["--agents", "4", "--insert-mode", "ref",
                            "--merge-mode", "dense"],
            "4 adaptive": ["--agents", "4", "--adaptive-exec"]}
    for name, flags in runs.items():
        reset_launches()
        t0 = time.perf_counter()
        got = simulate.main(["t0t1", *flags, "--device", "cuda"])
        t_card = time.perf_counter() - t0
        ran[name] = launches()
        want = simulate.main(["t0t1", *flags, "--device", "cpu"])
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


def profile_windows(eng, st, n: int = 10):
    """``n`` windows from state ``st`` under torch.profiler: ms a window,
    device ops a window and the device's busy share of the wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            st = eng.step_local(st)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / n * 1e3
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        raise AssertionError("the profile holds no device op")
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3 / n
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
          f" launches={ran} ({card})", flush=True)
    return eng, st, ran, dict(windows=windows, events=events, wall=wall)


def oracle_equal(label: str, built, runs: dict) -> None:
    """Every run's merged trace equals the port's oracle in full-row order,
    and its model counters and component tables the oracle's."""
    import numpy as np
    from repro_torch.core import merged_engine_trace, run_sequential
    from repro_torch.core import monitoring as mon
    from repro_torch.core.registry import registry_of
    t0 = time.perf_counter()
    ow, oc, want = run_sequential(*built, max_events=2_000_000)
    reg = registry_of(built[0])
    for name, st in runs.items():
        got = merged_engine_trace(st.trace, st.trace_n)
        if sorted(got) != sorted(want):
            raise AssertionError(f"{label} {name}: merged trace != oracle")
        c = st.counters.sum(0).cpu().numpy()
        if not np.array_equal(c[mon.N_COUNTERS:],
                              oc.numpy()[mon.N_COUNTERS:]):
            raise AssertionError(f"{label} {name}: model counters "
                                 f"{c[mon.N_COUNTERS:]} != oracle's "
                                 f"{oc.numpy()[mon.N_COUNTERS:]}")
        for f in reg.delta_schema:
            a = getattr(st.world, f)[0].cpu().numpy()
            b = getattr(ow, f).numpy()
            if a.tobytes() != b.tobytes():
                raise AssertionError(f"{label} {name}: world.{f} != oracle")
    ties = len(want) - len({(r[0], r[1]) for r in want})
    counts = {n: int(oc[i]) for n, i in reg.counters.items()
              if i >= mon.N_COUNTERS}
    print(f"[scenarios] {label}: {', '.join(runs)} == oracle in full-row "
          f"order ({len(want)} events, {ties} rows share (time, seq); "
          f"{counts}; oracle {time.perf_counter() - t0:.1f} s)", flush=True)


def phase_scenarios(card: str) -> dict:
    """The replica-cache and failure/repair models on the card: stitched,
    fused and adaptive runs against the CPU run and the oracle; then the
    failure model's log replica on every unit draw and int32 payload bit
    patterns through both front ends."""
    import torch
    from repro_torch.core import Engine
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
    t0 = time.perf_counter()
    state_equal(st, Engine(*built, trace_cap=65536,
                           device="cpu").run_local())
    print(f"[scenarios] cache: fused cuda == stitched cuda == stitched cpu "
          f"(cpu {time.perf_counter() - t0:.1f} s)", flush=True)
    oracle_equal("cache", built, {"stitched": st, "fused": st_f})
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
    t0 = time.perf_counter()
    state_equal(st, Engine(*built, trace_cap=65536,
                           device="cpu").run_local())
    eng_c = Engine(*built, trace_cap=65536, device="cpu")
    state_equal(st_a, eng_c.run_adaptive(max_windows=200_000,
                                         policy=policy))
    if eng_c.adaptive_rungs != eng_a.adaptive_rungs:
        raise AssertionError("failures adaptive: the rungs differ on the cpu")
    rungs = {w: eng_a.adaptive_rungs.count(i)
             for i, w in enumerate(FAIL_LADDER)}
    print(f"[scenarios] failures: fused cuda == stitched cuda == stitched "
          f"cpu, adaptive cuda == adaptive cpu (windows by width {rungs}; "
          f"cpu {time.perf_counter() - t0:.1f} s)", flush=True)
    oracle_equal("failures", built, {"stitched": st, "fused": st_f,
                                     "adaptive": st_a})
    out["failures"] = dict(stitched=nums, fused=nums_f, adaptive=nums_a,
                           ops_per_window=ops)

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
        (1, 9, 3, 700, 130, 32, True, 0)]
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
    for name, r in rows.items():
        ms = cuda_ms(r["fn"], iters=50)
        dev_ms = device_ms(r["fn"], r["kernel"])
        plain_ms = cuda_ms(r["plain"], iters=20)
        lib_ms = cuda_ms(r["lib"], iters=50) if r["lib"] is not None else None
        bms, by = bound(r["bytes"], r["ops"], r["rate"])
        tflops, peak = r["ops"] / ms / 1e9, r["rate"] / 1e12
        out[name] = dict(max_abs_err=err[name], ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                         bound_by=by)
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


# --------------------------------------------------------------- phase 4z
ZOO_MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


def state_close(label: str, got: dict, want: dict) -> float:
    """The decode states of two models (the card's and the CPU's): every
    KV cache and recurrent state within ``ZOO_MODEL_TOL``."""
    worst = 0.0
    if (got["kv"] is None) != (want["kv"] is None):
        raise AssertionError(f"{label}: KV caches differ in presence")
    if got["kv"] is not None:
        for f in ("k", "v", "length"):
            worst = max(worst, zoo_close(f"{label} kv.{f}",
                                         getattr(got["kv"], f).cpu(),
                                         getattr(want["kv"], f),
                                         ZOO_MODEL_TOL))
    for f in sorted(want["rnn"] or {}):
        worst = max(worst, zoo_close(f"{label} rnn.{f}", got["rnn"][f].cpu(),
                                     want["rnn"][f], ZOO_MODEL_TOL))
    return worst


def phase_model_path(card: str) -> dict:
    """hymba-1.5b and rwkv6-7b at full width and 2 layers in float32: the
    card (kernels) against the CPU (plain versions), one set of weights."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import build_model
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    new = {"hymba-1.5b": ("flash_attention", "ssd_scan"),
           "rwkv6-7b": ("rwkv6_scan",)}
    result = {}
    try:
        for arch, B, S in (("hymba-1.5b", 2, 2048), ("rwkv6-7b", 2, 1024)):
            cfg = dataclasses.replace(get_config(arch), n_layers=2,
                                      dtype="float32")
            t0 = time.perf_counter()
            cpu = build_model(cfg, device="cpu").init(
                torch.Generator().manual_seed(0))
            gpu = build_model(cfg, device="cuda")
            gpu.load_state_dict(cpu.state_dict())
            g = torch.Generator().manual_seed(1)
            toks = torch.randint(0, cfg.vocab, (B, S), generator=g)
            steps = torch.randint(0, cfg.vocab, (4, B, 1), generator=g)
            torch.cuda.synchronize()
            reset_launches()
            got, gstate = gpu.prefill_fn({"tokens": toks.cuda()})
            torch.cuda.synchronize()
            ran = launches()
            want, wstate = cpu.prefill_fn({"tokens": toks})
            e = zoo_close(f"{arch} prefill logits", got.cpu(), want,
                          ZOO_MODEL_TOL)
            es = state_close(f"{arch} prefill state", gstate, wstate)
            for k in new[arch]:
                if ran[k] != cfg.n_layers:
                    raise AssertionError(f"{arch}: {k} launched {ran[k]} "
                                         f"times for {cfg.n_layers} layers")
            ed = 0.0
            for i in range(4):
                got, gstate = gpu.decode_fn(gstate, steps[i].cuda(), S + i)
                want, wstate = cpu.decode_fn(wstate, steps[i], S + i)
                ed = max(ed, zoo_close(f"{arch} decode step {i} logits",
                                       got.cpu(), want, ZOO_MODEL_TOL))
            es = max(es, state_close(f"{arch} decode state", gstate, wstate))
            print(f"[zoo model] {arch} d={cfg.d_model} 2 layers B={B} S={S} "
                  f"float32: card == cpu within {ZOO_MODEL_TOL}: prefill "
                  f"logits max abs err {e:.3e}, 4 teacher-forced decode "
                  f"steps {ed:.3e}, states {es:.3e}; launches "
                  f"{ {k: ran[k] for k in new[arch]} } "
                  f"({time.perf_counter() - t0:.1f} s, {card})", flush=True)
            result[arch] = {k: ran[k] for k in new[arch]}
            del cpu, gpu, gstate, wstate
            torch.cuda.empty_cache()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return result


# --------------------------------------------------------------- phase 4s
def serve_full(arch: str, card: str) -> dict:
    """``ServeEngine`` at full width and depth in bfloat16 on the card: 4
    requests of 2048 random tokens in 4 slots, 16 new tokens each."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    slots, prompt, max_new = 4, 2048, 16
    cfg = dataclasses.replace(get_config(arch), cache_headroom=max_new)
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
    print(f"[serve] {arch} full width and depth ({n_params} params, "
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
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if not kern:
            raise AssertionError(f"{arch} {label}: the profile holds no "
                                 f"device op")
        busy_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
        top = sorted(prof.key_averages(), key=self_device_us, reverse=True)
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


def phase_serve(card: str) -> dict:
    runs = {}
    for arch, want in (("hymba-1.5b", {"flash_attention": 32, "ssd_scan": 32,
                                       "rwkv6_scan": 0}),
                       ("rwkv6-7b", {"flash_attention": 0, "ssd_scan": 0,
                                     "rwkv6_scan": 32})):
        runs[arch] = serve_full(arch, card)
        got = {k: runs[arch]["admit_launches"][k] for k in want}
        if got != want:
            raise AssertionError(f"{arch} admit launches {got}, want {want}")
    return runs


# --------------------------------------------------------------- phase 5z
def phase_serve_entry() -> None:
    import torch
    from repro_torch.launch import serve
    reset_launches()
    got = serve.main(["--arch", "hymba-1.5b", "--device", "cuda"])
    ran = launches()
    want = serve.main(["--arch", "hymba-1.5b", "--device", "cpu"])
    keys = ("done", "requests", "tokens")
    if [got[k] for k in keys] != [want[k] for k in keys]:
        raise AssertionError(f"serve hymba-1.5b: cuda {got} != cpu {want}")
    for k in ("flash_attention", "ssd_scan"):
        if ran[k] == 0:
            raise AssertionError(f"serve --device cuda never launched {k}")
    print(f"[serve entry] hymba-1.5b smoke: cuda == cpu "
          f"({[got[k] for k in keys]}; launches {ran})", flush=True)
    for arch in ("hymba-1.5b", "rwkv6-7b"):
        got = serve.main(["--arch", arch, "--full", "--prompt-len", "2048",
                          "--device", "cuda"])
        if got["done"] != got["requests"]:
            raise AssertionError(f"serve --full {arch}: {got}")
        torch.cuda.empty_cache()


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
    from repro_torch.kernels import build
    from repro_torch.kernels import event_select as es
    from repro_torch.kernels import ref

    card = smi()
    print(f"[device] {card}; torch {torch.__version__}; CUDA "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}",
          flush=True)
    build.build_all()
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
    timings = phase_kernels(es, ref)
    timings["maxmin_rates"] = phase_maxmin(torch.Generator().manual_seed(1))
    # before phase 4's profiles: after a long profiled run, a short one
    # records no device op (device_ms needs them)
    timings.update(phase_zoo_kernels())
    main_run = phase_main_path(card)
    fused_run = phase_fused_path(card, main_run)
    phase_workload(card)
    phase_profile(card, fused=False)
    phase_profile(card, fused=True)
    phase_entry_point()
    phase_scenarios(card)
    phase_model_path(card)
    served = phase_serve(card)
    phase_serve_entry()

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
