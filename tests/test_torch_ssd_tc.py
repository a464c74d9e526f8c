"""The arithmetic of the port's tensor-core SSD kernel, rehearsed in float32.

``csrc/rwkv6_scan.cu::ssd::ssd_tc_kernel`` (bfloat16 ``gla_scan`` in mode
"v", hymba's SSD) cannot run here, so this file models what it computes
differently from the plain ``ref.gla_scan``: each CTA owns 16 columns of v
(and of w, the output and the state) and recomputes the shared
``B = tril(q k^T)`` itself; the products run on TF32 operands (q and k are
bf16, exact in TF32; ``tf32(B)``, ``tf32(v_t)`` and the state rounded to
nearest, ties away from zero, as ``cvt.rna``); each of the four warps
carries the state of its 16 rows of the chunk, ``S_w = qs[-1] * (S_w +
k_w^T v_t)`` with ``v_t`` split into ``hi = tf32(v_t)`` and ``lo =
tf32(v_t - hi)``, and the state is their sum; the cumulative decay is
summed in segments of 8 rows whose totals are added first. The model is
held against ``ref.gla_scan`` (itself held against the JAX ``gla_pallas``
in tests/test_torch_gla.py) at hymba-1.5b's widths on ``chip_smoke.py``
phase 3z's inputs and tolerances: a bfloat16 output within 2e-2, the
float32 state within atol 5e-5, rtol 5e-4. Phase 3z holds the kernel itself
to the same bounds on the card. The column split rests on mode "v" treating
each column of v on its own, which the last test checks on the plain scan.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import ref  # noqa: E402
from test_torch_gla_tc import (BF16_TOL, GLA_TOL, decay_scan, mm,  # noqa: E402
                               tf32)

SLICE = 16   # columns of v a CTA owns
ROWS = 16    # rows of the chunk whose state a warp carries
WARPS = 4
SEG = 8      # rows a thread sums in the decay scan


def ssd_slice_model(q, k, v, w, chunk: int):
    """One CTA's columns: (out, state) as the kernel computes them."""
    bh, s, dk = q.shape
    qf, kf, vf = (x.float() for x in (q, k, v))
    ii = torch.arange(chunk)
    inclusive = ii[None, :] <= ii[:, None]
    parts = [torch.zeros((bh, dk, v.shape[-1])) for _ in range(WARPS)]
    outs = []
    for c0 in range(0, s, chunk):
        qc, kc, vc, wc = (x[:, c0:c0 + chunk] for x in (qf, kf, vf, w))
        qs = torch.exp(decay_scan(torch.log(wc), SEG))
        last = qs[:, -1]
        state = ((parts[0] + parts[1]) + parts[2]) + parts[3]
        b = torch.where(inclusive, mm(qc, kc.transpose(1, 2)), 0.0)
        v_t = vc / qs
        outs.append(qs * (mm(qc, tf32(state)) + mm(tf32(b), tf32(v_t))))
        hi = tf32(v_t)
        lo = tf32(v_t - hi)
        for p in range(WARPS):
            rows = slice(ROWS * p, ROWS * (p + 1))
            k_t = kc[:, rows].transpose(1, 2)
            upd = (parts[p] + mm(k_t, lo[:, rows])) + mm(k_t, hi[:, rows])
            parts[p] = last[:, None, :] * upd
    state = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    return torch.cat(outs, 1).to(q.dtype), state


def ssd_tc_model(q, k, v, w, chunk: int):
    """The whole call: the slices of 16 columns side by side."""
    got = [ssd_slice_model(q, k, v[..., j:j + SLICE], w[..., j:j + SLICE],
                           chunk) for j in range(0, v.shape[-1], SLICE)]
    return (torch.cat([o for o, _ in got], -1),
            torch.cat([st for _, st in got], -1))


def ssd_inputs(seed, bh, s, dk, dv, dtype=torch.bfloat16):
    """chip_smoke.py phase 3z's distribution for mode "v": q (C), k (B) and
    v at scale 0.5 in ``dtype``, the decays w = exp(-exp(0.5 n - 1)) per
    column of v (numpy draws)."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).float()

    q, k = (draw(bh, s, dk).mul(0.5).to(dtype) for _ in range(2))
    v = draw(bh, s, dv).mul(0.5).to(dtype)
    w = torch.exp(-torch.exp(draw(bh, s, dv) * 0.5 - 1.0))
    return q, k, v, w


@pytest.mark.parametrize("bh,s,dk,dv,chunk", [
    (4, 256, 16, 64, 64),    # hymba-1.5b's SSD widths: state 16, head 64
    (3, 1000, 16, 64, 50),   # S 1000: the divisor rule's chunk 50
])
def test_ssd_tc_arithmetic_within_phase_3z_tolerances(bh, s, dk, dv, chunk):
    """TF32 products over 16-column slices, per-warp partial states with
    the hi/lo update, against the plain float32 scan: the bf16 output
    within 2e-2, the state within GLA_TOL."""
    q, k, v, w = ssd_inputs(18, bh, s, dk, dv)
    got, got_state = ssd_tc_model(q, k, v, w, chunk)
    want, want_state = ref.gla_scan(q, k, v, w, mode="v", chunk=chunk)
    assert got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    torch.testing.assert_close(got_state, want_state, **GLA_TOL)


def test_ssd_columns_are_independent():
    """What the grid rests on: the plain mode-"v" scan of a slice of v's
    and w's columns equals the same columns of the whole call, output and
    state, so a CTA per slice needs no pass across CTAs."""
    q, k, v, w = ssd_inputs(7, 4, 256, 16, 64, dtype=torch.float32)
    want, want_state = ref.gla_scan(q, k, v, w, mode="v", chunk=64)
    for j in range(0, 64, SLICE):
        cols = slice(j, j + SLICE)
        got, got_state = ref.gla_scan(q, k, v[..., cols], w[..., cols],
                                      mode="v", chunk=64)
        torch.testing.assert_close(got, want[..., cols], atol=1e-6, rtol=0)
        torch.testing.assert_close(got_state, want_state[..., cols],
                                   atol=1e-6, rtol=0)
