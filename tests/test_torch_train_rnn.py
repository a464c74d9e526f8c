"""Training the port's hybrid and ssm families against the JAX package, in
float32 on the CPU, as tests/test_torch_train_dense.py does (tolerances in
``train_harness``): the gradients of the chunked scans are the
reference's chunked form's (``linear_rnn.GlaScan`` recomputes it in its
backward), beside the attention's (``layers.FlashAttention``).

Each reference configuration compiles once in this file, so it holds two
tests (ROADMAP.md, test budget)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import linear_rnn as JR  # noqa: E402
from repro_torch.models import linear_rnn as R  # noqa: E402
from train_harness import compare_arch  # noqa: E402


def test_hymba_step_as_the_reference():
    """hymba-1.5b: sliding-window attention beside the SSD scan (mode
    "v"). Then one chunk of 64 decays of 0.45 (cumulative 6e-23): the
    reference's gradient of the decays is not finite there (its chunked
    form divides by the cumulative decay, and v / Qs**2 overflows float32)
    while its forward is; the port's backward, in float64, is finite."""
    compare_arch("hymba-1.5b")
    rng = np.random.default_rng(4)
    q, k = (rng.standard_normal((1, 64, 2, 16)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((1, 64, 2, 32)).astype(np.float32)
    w = np.full((1, 64, 2, 32), 0.45, np.float32)
    jx = [jnp.asarray(x) for x in (q, k, v, w)]
    out = JR.gla_chunked(*jx, mode="v", chunk=64)[0]
    jg = jax.grad(lambda *a: JR.gla_chunked(*a, mode="v", chunk=64)[0].sum(),
                  argnums=(0, 1, 2, 3))(*jx)
    assert bool(jnp.isfinite(out).all())
    assert not bool(jnp.isfinite(jg[3]).all())
    ins = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, w)]
    got = torch.autograd.grad(R.GlaScan.apply(*ins, None, "v", 64)[0].sum(),
                              ins)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    for a, b in zip(got[:3], jg[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-4 * float(np.abs(b).max()))


def test_rwkv6_step_as_the_reference():
    """rwkv6-7b: the RWKV6 time mix (mode "k", the bonus u)."""
    compare_arch("rwkv6-7b")
