"""The plain attention of the port (what CPU tensors take, and what
chip_smoke.py holds the CUDA flash-attention kernel against on the card)
against the JAX Pallas ``flash_attention`` in interpret mode and
``repro.kernels.ref.attention_ref``, at tests/test_kernels.py's tolerances
(2e-6 in float32, 2e-2 in bfloat16). Inputs come from a numpy seed and are
cast to the working dtype by both frameworks (the same round-to-nearest).
Three cases here cover GQA (groups 5, 3 and 2), a window, bfloat16 and a
non-causal call; ``tests/test_torch_attention_edges.py`` runs three more
through the same check: a bfloat16 window and lengths that are no multiple
of the kernels' 64- and 128-row blocks, and causal calls with fewer and
with more queries than keys. The cases with a window also run the model's
layout, (b, s, heads, head_dim) flattened to head-major rows, against the
JAX model's ``_chunked_attention``. Each case runs Pallas in interpret
mode for seconds, so each file holds 3 (xdist ``loadfile`` hands files of
at most 3 tests out after the long reference files).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention as fa_pallas  # noqa: E402
from repro.kernels.ref import attention_ref  # noqa: E402
from repro.models.layers import _chunked_attention  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402


@pytest.mark.parametrize("bh,bkv,sq,skv,d,causal,window,dtype,block", [
    (10, 2, 48, 48, 16, True, 32, "float32", 16),     # hymba-like: group 5
    (6, 2, 64, 64, 32, True, 0, "bfloat16", 32),      # smollm-like: group 3
    (4, 2, 32, 64, 64, False, 0, "float32", 32),      # cross-attention shape
])
def test_plain_attention_matches_pallas_and_ref(bh, bkv, sq, skv, d, causal,
                                                window, dtype, block):
    check_attention(bh, bkv, sq, skv, d, causal, window, dtype, block)


def check_attention(bh, bkv, sq, skv, d, causal, window, dtype, block):
    """The plain attention against the Pallas kernel (interpret mode) and
    ``attention_ref``; with a window, also in the model's layout against
    ``_chunked_attention``."""
    rng = np.random.default_rng(bh * 100 + sq)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in
               ((bh, sq, d), (bkv, skv, d), (bkv, skv, d)))
    jq, jk, jv = (jnp.asarray(x, jnp.dtype(dtype)) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype))
                  for x in (q, k, v))
    kw = dict(causal=causal, window=window)
    got = ref.attention(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and got.shape == (bh, sq, d)
    assert torch.equal(ops.flash_attention(tq, tk, tv, **kw), got)
    tol = 2e-6 if dtype == "float32" else 2e-2
    for want in (fa_pallas(jq, jk, jv, block_q=block, block_k=block,
                           interpret=True, **kw),
                 attention_ref(jq, jk, jv, **kw)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)

    if window:
        # the model's layout: head h of batch row b at row b * H + h, KV
        # head kv at row b * n_kv + kv, so row // group is its KV head
        b = 2
        q4, k4, v4 = (x.reshape(b, x.shape[0] // b, x.shape[1], d)
                      .transpose(0, 2, 1, 3) for x in (q, k, v))
        want = _chunked_attention(
            jnp.asarray(q4), jnp.asarray(k4), jnp.asarray(v4), causal=True,
            window=window, q_offset=0, kv_len_valid=jnp.int32(skv),
            chunk_q=16, chunk_kv=16)
        t4 = [torch.from_numpy(np.ascontiguousarray(x)) for x in (q4, k4, v4)]
        got = ops.flash_attention(*map(L._heads_first, t4), causal=True,
                                  window=window)
        got = got.reshape(b, bh // b, sq, d).permute(0, 2, 1, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-6, rtol=2e-6)
