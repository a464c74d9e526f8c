"""The plain chunked gated linear attention of the port (what CPU tensors
take, and what chip_smoke.py holds the CUDA kernel of both modes against
on the card) against the JAX Pallas ``gla_pallas`` in interpret mode and
the sequential ``gla_ref``, at tests/test_kernels.py's tolerances (atol
5e-5, rtol 5e-4); a bfloat16 output is rounded once from float32 in both
packages, so it is compared at 2e-2 (its state stays float32 and at the
float32 tolerance). Inputs come from a numpy seed, decays in the JAX
suite's range exp(-exp(N(0, 0.5) - 1)). The third case runs the model's
``gla_chunked`` at a length the default chunk does not divide (S = 100:
the divisor rule picks 50) against the JAX model's ``gla_chunked``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rwkv6_scan import gla_pallas  # noqa: E402
from repro.models import linear_rnn as JR  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import linear_rnn as R  # noqa: E402

F32_TOL = dict(atol=5e-5, rtol=5e-4)


def inputs(rng, bh, s, dk, dv, mode):
    q, k = (rng.standard_normal((bh, s, dk)) * 0.5 for _ in range(2))
    v = rng.standard_normal((bh, s, dv)) * 0.5
    w = np.exp(-np.exp(rng.standard_normal(
        (bh, s, dk if mode == "k" else dv)) * 0.5 - 1.0))
    u = rng.standard_normal((bh, dk)) * 0.3
    return [x.astype(np.float32) for x in (q, k, v, w, u)]


@pytest.mark.parametrize("mode,bh,s,dk,dv,chunk,dtype", [
    ("k", 4, 64, 16, 32, 16, "float32"),     # RWKV6: decay on K, bonus u
    ("v", 6, 48, 8, 16, 16, "bfloat16"),     # SSD: decay on V
])
def test_plain_gla_matches_pallas_and_ref(mode, bh, s, dk, dv, chunk, dtype):
    q, k, v, w, u = inputs(np.random.default_rng(11), bh, s, dk, dv, mode)
    td, jd = getattr(torch, dtype), jnp.dtype(dtype)
    tq, tk, tv = (torch.from_numpy(x).to(td) for x in (q, k, v))
    tw, tu = torch.from_numpy(w), torch.from_numpy(u)
    if mode == "k":
        got, state = ref.gla_scan(tq, tk, tv, tw, tu, mode="k", chunk=chunk)
        via_ops = ops.rwkv6_scan(tq, tk, tv, tw, tu, chunk=chunk)
    else:
        got, state = ref.gla_scan(tq, tk, tv, tw, mode="v", chunk=chunk)
        via_ops = ops.ssd_scan(tq, tk, tv, tw, chunk=chunk)
    assert got.dtype == td and state.dtype == torch.float32
    assert torch.equal(via_ops[0], got) and torch.equal(via_ops[1], state)

    jq, jk, jv = (jnp.asarray(x, jd) for x in (q, k, v))
    jout, jstate = gla_pallas(jq, jk, jv, jnp.asarray(w),
                              jnp.asarray(u) if mode == "k" else None,
                              mode=mode, chunk=chunk, interpret=True)
    tr = lambda x: x.swapaxes(0, 1)[None]              # (1, s, bh, d)
    rout, rstate = JR.gla_ref(tr(jq), tr(jk), tr(jv), tr(jnp.asarray(w)),
                              bonus=jnp.asarray(u) if mode == "k" else None,
                              mode=mode)
    out_tol = F32_TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    for want_out, want_state in ((jout, jstate),
                                 (rout[0].swapaxes(0, 1), rstate[0])):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want_out, np.float32),
                                   **out_tol)
        np.testing.assert_allclose(state.numpy(), np.asarray(want_state),
                                   **F32_TOL)


def test_model_gla_chunked_takes_the_divisor_chunk():
    """S = 100 with chunk 64: both models' rule picks 50; the port's
    ``gla_chunked`` (head-major rows through ``ops``) equals the JAX
    model's in both modes, and the Pallas kernel at chunk 50."""
    assert R._chunk(100, 64) == 50 and R._chunk(1000, 64) == 50
    b, s, h, d = 2, 100, 3, 16
    rng = np.random.default_rng(13)
    for mode in ("k", "v"):
        q, k, v, w, _ = inputs(rng, b * h, s, d, d, mode)
        u = (rng.standard_normal((h, d)) * 0.3).astype(np.float32)
        # (b * h, s, d) rows -> the model's (b, s, h, d)
        q4, k4, v4, w4 = (x.reshape(b, h, s, d).transpose(0, 2, 1, 3)
                          for x in (q, k, v, w))
        bonus = u if mode == "k" else None
        want, wstate = JR.gla_chunked(
            *(jnp.asarray(x) for x in (q4, k4, v4, w4)),
            bonus=None if bonus is None else jnp.asarray(bonus), mode=mode,
            chunk=64)
        got, state = R.gla_chunked(
            *(torch.from_numpy(np.ascontiguousarray(x))
              for x in (q4, k4, v4, w4)),
            bonus=None if bonus is None else torch.from_numpy(bonus),
            mode=mode, chunk=64)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
        np.testing.assert_allclose(state.numpy(), np.asarray(wstate),
                                   **F32_TOL)
        pout, pstate = gla_pallas(
            *(jnp.asarray(x) for x in (q, k, v, w)),
            jnp.asarray(np.tile(u, (b, 1))) if mode == "k" else None,
            mode=mode, chunk=50, interpret=True)
        np.testing.assert_allclose(
            got.permute(0, 2, 1, 3).reshape(b * h, s, d).numpy(),
            np.asarray(pout), **F32_TOL)
        np.testing.assert_allclose(state.reshape(b * h, d, d).numpy(),
                                   np.asarray(pstate), **F32_TOL)
