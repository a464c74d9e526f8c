"""The port's failure/repair model (``repro_torch.scenarios.failures``)
against the reference's, byte for byte: the XLA:CPU logarithm replica on
every value the LCG's unit draw takes, the LCG and its draws over streams
that wrap int32, each handler lane-wise against the reference's vmapped
handler, then ``run_local`` on the stitched and the fused front end at one
and two agents and the oracle, and the reference's failing property draw,
held in full-row order, which is also the two-agent run.

The runs compile JAX engine code, so this file holds two tests (see
test_torch_cache.py); the helpers come from there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several worker processes on one machine: keep torch to one
# thread each, as the tensors here are small
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import monitoring as jmon  # noqa: E402
from repro.core import merged_engine_trace as j_merged  # noqa: E402
from repro.scenarios import failures as jfail  # noqa: E402
from repro_torch.scenarios import failures as tfail  # noqa: E402

from test_torch_cache import (assert_builds_equal, check_handler_lanes,  # noqa: E402,E501
                              event_rows, foreign_lanes_run, full_rows,
                              run_engines_and_oracles)


def unit_values():
    """Every value ``_unit`` takes: (k + 0.5) / 2**22 for k < 2**22."""
    k = np.arange(1 << 22, dtype=np.int32)
    return ((k.astype(np.float32) + np.float32(0.5))
            / np.float32(1 << 22)).astype(np.float32)


def test_log_lcg_draws_and_handlers_equal_reference():
    u = unit_values()
    got = tfail.xla_log(torch.from_numpy(u)).numpy()
    want = np.asarray(jax.jit(jnp.log)(jnp.asarray(u)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))

    # streams from seeds at and around the int32 ends, 200 steps each
    x = np.array([0, 1, -1, 2**31 - 1, -2**31, 1 + 7919 * 63, 123456789],
                 np.int32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    wrapped = False
    for _ in range(200):
        prev = xt
        xt, xj = tfail._lcg(xt), jfail._lcg(xj)
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
        wrapped |= bool(((prev.long() * 1664525 + 1013904223)
                         != xt.long()).any())
        np.testing.assert_array_equal(
            tfail._unit(xt).numpy().view(np.int32),
            np.asarray(jfail._unit(xj)).view(np.int32))
        for mean in (0, 1, 6, 100, 5000):
            np.testing.assert_array_equal(
                tfail._expo(xt, torch.full_like(xt, mean)).numpy(),
                np.asarray(jfail._expo(xj, jnp.int32(mean))))
    assert wrapped

    # each handler by lane, on a farm row with busy CPUs and queued jobs
    rng = np.random.default_rng(11)
    tbuilt, tids = tfail.build_failure_scenario(n_farms=3, n_cpu=4,
                                                procs_per_farm=2)
    jbuilt, jids = jfail.build_failure_scenario(n_farms=3, n_cpu=4,
                                                procs_per_farm=2)
    assert tids == jids
    assert_builds_equal(tbuilt, jbuilt)
    jw = jbuilt[0]
    jq = (rng.random(np.asarray(jw.jobq).shape) * 9).astype(np.float32)
    jq[..., 2] = rng.integers(-1, 6, jq.shape[:-1])
    jw = jw._replace(
        cpu_busy=jnp.asarray(rng.random(np.asarray(jw.cpu_busy).shape) < .5,
                             jnp.int32),
        cpu_mem=jnp.asarray(rng.random(np.asarray(jw.cpu_mem).shape),
                            jnp.float32),
        jobq=jnp.asarray(jq), jobq_n=jnp.asarray([0, 3, 8], jnp.int32),
        fp_rng=jnp.asarray(rng.integers(-2**31, 2**31, 6), jnp.int32),
        fp_left=jnp.asarray([0, 1, 2, 3, 1, 5], jnp.int32),
        fp_burst=jnp.asarray([1, 2, 3, 3, 2, 1], jnp.int32),
        fp_repair_mean=jnp.asarray([1, 6, 40, 3, 9, 0], jnp.int32))
    B = 16
    procs, farms = jids["procs"], jids["farms"]
    for kind in (tfail.K_FAIL_TICK, tfail.CPU_FAIL.id, tfail.CPU_REPAIR.id):
        dst = rng.choice(procs if kind == tfail.K_FAIL_TICK else farms, B)
        payload = np.zeros((B, 8), np.float32)
        payload[:, :2] = np.stack([rng.integers(0, 4, B),
                                   rng.integers(1, 30, B)], 1).astype(
            np.int32).view(np.float32)
        check_handler_lanes(tfail.FAIL_REGISTRY, jfail.FAIL_REGISTRY, jw,
                            kind, event_rows(rng, kind, dst, payload))
    tworld = tbuilt[0].__class__(*(x[None] for x in tbuilt[0]))
    foreign_lanes_run(tfail.FAIL_REGISTRY, tworld, rng)


def test_failure_runs_equal_jax_and_oracle():
    """One agent, with a job generator a farm, two processes a farm
    (same-row collisions through the fallback) and bursts of 3; then two
    agents at the reference's failing property draw."""
    kw = dict(n_farms=2, n_cpu=4, procs_per_farm=2, burst=3, n_bursts=2,
              jobs_per_farm=3)
    tbuilt, _ = tfail.build_failure_scenario(**kw)
    jbuilt, _ = jfail.build_failure_scenario(**kw)
    assert_builds_equal(tbuilt, jbuilt)
    jstate, _ = run_engines_and_oracles(tbuilt, jbuilt)
    c = jstate["counters"].sum(0)
    assert c[jmon.C_BATCH_FALLBACK] > 0
    assert c[tfail.C_CPU_FAILS] > 0 and c[tfail.C_CPU_REPAIRS] > 0
    assert c[jmon.C_JOBS_DONE] > 0

    # two agents, at the draw where the reference's property test fails:
    # its engine's merged trace leaves the oracle's (time, seq) order on a
    # tie but equals it in full-row order; the port equals the JAX engine
    # byte for byte and the oracle in full-row order
    p = dict(n_farms=3, n_cpu=2, procs_per_farm=1, burst=3, fail_mean=13,
             repair_mean=2, n_bursts=4, jobs_per_farm=3, seed=0, n_agents=2)
    tbuilt, _ = tfail.build_failure_scenario(**p)
    jbuilt, _ = jfail.build_failure_scenario(**p)
    assert_builds_equal(tbuilt, jbuilt)
    jstate, otrace = run_engines_and_oracles(tbuilt, jbuilt)
    jtrace = j_merged(jstate["trace"], jstate["trace_n"])
    assert jtrace != otrace and full_rows(jtrace) == full_rows(otrace)
    c = jstate["counters"].sum(0)
    assert c[jmon.C_BATCH_FALLBACK] > 0 and c[jmon.C_MSGS_REMOTE] > 0
