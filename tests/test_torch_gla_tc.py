"""The arithmetic of the port's tensor-core RWKV6 kernel, rehearsed in float32.

``csrc/rwkv6_scan.cu::rwkv6_tc_kernel`` cannot run here, so this file models
what it computes differently from the plain ``ref.gla_scan``: the operands of
the three output products (``r_t k_t^T``, ``r_t S``, ``A v``) rounded to
TF32 (to nearest, ties away from zero, as ``cvt.rna``), the state update's
``x = k_t * qs[-1]`` split into ``hi = tf32(x)`` and ``lo = tf32(x - hi)``
(two products against v), and the cumulative decay summed in four segments
of 16 rows whose totals are added first. The model is held against
``ref.gla_scan`` (itself held against the JAX ``gla_pallas`` and ``gla_ref``
in tests/test_torch_gla.py) at rwkv6-7b's widths on ``chip_smoke.py`` phase
3z's inputs and tolerances: a bfloat16 output within 2e-2, the float32
state within atol 5e-5, rtol 5e-4. Phase 3z holds the kernel itself to the
same bounds on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import ref  # noqa: E402

GLA_TOL = dict(atol=5e-5, rtol=5e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
SEG = 16   # rows a thread sums in the kernel's decay scan


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10 mantissa bits: to nearest, ties away from
    zero (the sign bit is apart, so adding half an ulp to the magnitude)."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A tensor-core product of rounded operands: exact products, float32
    result (summed in float64 here)."""
    return torch.bmm(a.double(), b.double()).float()


def decay_scan(lw: torch.Tensor, seg_rows: int = SEG) -> torch.Tensor:
    """Inclusive cumulative sum over the chunk's rows (dim 1) in the
    kernel's order: each segment of ``seg_rows`` rows summed in order, the
    earlier segments' totals added first, then the segment's rows."""
    bh, c, d = lw.shape
    n_seg = -(-c // seg_rows)
    pad = torch.zeros((bh, n_seg * seg_rows - c, d))
    seg = torch.cat([lw, pad], 1).view(bh, n_seg, seg_rows, d)
    tot = torch.zeros((bh, n_seg, d))
    for r in range(seg_rows):
        tot = tot + seg[:, :, r]
    out = torch.empty_like(seg)
    for s in range(n_seg):
        cum = torch.zeros((bh, d))
        for s2 in range(s):
            cum = cum + tot[:, s2]
        for r in range(seg_rows):
            cum = cum + seg[:, s, r]
            out[:, s, r] = cum
    return out.view(bh, n_seg * seg_rows, d)[:, :c]


def gla_tc_model(q, k, v, w, u, chunk: int, split: bool = True):
    """RWKV6 (mode "k") as the tensor-core kernel computes it; ``split``
    False rounds the state update's x once instead of hi + lo."""
    bh, s, dk = q.shape
    qf, kf, vf = (x.float() for x in (q, k, v))
    ii = torch.arange(chunk)
    lower = ii[None, :] < ii[:, None]
    diag_mask = ii[None, :] == ii[:, None]
    state = torch.zeros((bh, dk, v.shape[-1]))
    outs = []
    for c0 in range(0, s, chunk):
        qc, kc, vc, wc = (x[:, c0:c0 + chunk] for x in (qf, kf, vf, w))
        qs = torch.exp(decay_scan(torch.log(wc)))
        last = qs[:, -1]
        r_t = tf32(qc * (qs / wc))
        k_t = kc / qs
        a = torch.where(lower, mm(r_t, tf32(k_t).transpose(1, 2)), 0.0)
        diag = torch.sum(qc * u[:, None, :] * kc, dim=-1)
        a = a + torch.where(diag_mask, diag[:, :, None], 0.0)
        outs.append(mm(r_t, tf32(state)) + mm(tf32(a), vc))
        x = (k_t * last[:, None, :]).transpose(1, 2)
        hi = tf32(x)
        upd = mm(hi, vc) + mm(tf32(x - hi), vc) if split else mm(hi, vc)
        state = state * last[:, :, None] + upd
    return torch.cat(outs, 1).to(q.dtype), state


def phase_3z_inputs(seed, bh, s, dk, dv):
    """chip_smoke.py phase 3z's distribution: bf16 q, k, v at scale 0.5,
    w = exp(-exp(0.5 n - 1)), u at 0.3 (numpy draws)."""
    rng = np.random.default_rng(seed)
    q, k = (torch.from_numpy(rng.standard_normal((bh, s, dk)) * 0.5)
            .float().to(torch.bfloat16) for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((bh, s, dv)) * 0.5).float().to(
        torch.bfloat16)
    w = torch.exp(-torch.exp(torch.from_numpy(
        rng.standard_normal((bh, s, dk))).float() * 0.5 - 1.0))
    u = torch.from_numpy(rng.standard_normal((bh, dk)) * 0.3).float()
    return q, k, v, w, u


@pytest.mark.parametrize("bh,s,dk,dv,chunk", [
    (8, 512, 64, 64, 64),    # rwkv6-7b's widths
    (4, 100, 64, 64, 50),    # the divisor rule's chunk 50: a short segment
])
def test_tc_arithmetic_within_phase_3z_tolerances(bh, s, dk, dv, chunk):
    """TF32 output products and the hi/lo state update, against the plain
    float32 scan: the bf16 output within 2e-2, the state within GLA_TOL."""
    q, k, v, w, u = phase_3z_inputs(17, bh, s, dk, dv)
    got, got_state = gla_tc_model(q, k, v, w, u, chunk)
    want, want_state = ref.gla_scan(q, k, v, w, u, mode="k", chunk=chunk)
    assert got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    torch.testing.assert_close(got_state, want_state, **GLA_TOL)


def test_one_tf32_rounding_of_the_state_update_fails_its_tolerance():
    """Why the split: one TF32 rounding of x in the carried state update
    (float32 accumulation still) leaves the state outside GLA_TOL at
    rwkv6-7b's widths, while hi + lo stays well inside it."""
    q, k, v, w, u = phase_3z_inputs(5, 8, 512, 64, 64)
    _, want = ref.gla_scan(q, k, v, w, u, mode="k", chunk=64)
    _, split = gla_tc_model(q, k, v, w, u, 64)
    _, single = gla_tc_model(q, k, v, w, u, 64, split=False)

    def worst(got):
        lim = GLA_TOL["atol"] + GLA_TOL["rtol"] * want.abs()
        return float(((got - want).abs() / lim).max())

    assert worst(split) < 0.5
    assert worst(single) > 1.0
