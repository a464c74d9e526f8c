"""The ``tri`` causal scheme against the JAX package's, on the CPU.

* ``layers.chunked_attention(scheme="tri")`` against the reference's eager
  ``_chunked_attention(scheme="tri")``: forward, and the gradients in q, k
  and v (``torch.autograd`` against ``jax.vjp``), causal, windowed and
  GQA, at chunks of 16 and 32 with ``chunk_q == chunk_kv``, at the
  float32 tolerance of ``tests/test_kernels.py::test_flash_attention_sweep``
  (2e-6) for the forward and of
  ``test_flash_attention_matches_model_path`` (2e-5) for the gradients.
  Where ``chunk_q != chunk_kv`` the port's ``tri`` visits the key chunks
  of each query chunk's band and equals its ``rect``; the reference's
  indexes key chunks by the query chunk's index, so its ``tri`` drops keys
  there and differs from its ``rect`` (ROADMAP.md §3's caveat).
* The dry run's count with ``causal_scheme="tri"``: ``run_cell`` on
  ``meta`` for hymba-1.5b (window 32) and smollm-135m, smoke configs;
  prefill equal to the reference's ``stablehlo_costs`` of its ``tri``
  lowering (lowered, not compiled), integer for integer, training equal to
  that plus the itemised recomputes (``test_torch_dryrun.extra_work``).

The reference's attention runs eagerly and its steps are only lowered, so
no JAX function is compiled whole; two tests, so the file queues after the
larger ones (ROADMAP.md, test budget).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.layers import _chunked_attention  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

from test_torch_dryrun import (B, extra_work, port_costs,  # noqa: E402
                               reference_costs)

FWD_TOL, GRAD_TOL = 2e-6, 2e-5


def _inputs(seed, b, s, h, kv, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))]


def _ref_attention(q, k, v, scheme, window, cq, ck):
    return _chunked_attention(q, k, v, causal=True, window=window,
                              q_offset=0, kv_len_valid=jnp.int32(q.shape[1]),
                              chunk_q=cq, chunk_kv=ck, scheme=scheme)


def _reference(arrays, scheme, window, cq, ck):
    """The reference's output and the gradients of its weighted sum."""
    w = jnp.asarray(np.random.default_rng(7).standard_normal(
        arrays[0].shape).astype(np.float32))
    out, pull = jax.vjp(lambda *a: _ref_attention(*a, scheme, window, cq, ck),
                        *[jnp.asarray(a) for a in arrays])
    return (np.asarray(out), [np.asarray(g) for g in pull(w)],
            np.asarray(w))


def _port(arrays, scheme, window, cq, ck, w):
    q, k, v = (torch.tensor(a, requires_grad=True) for a in arrays)
    out = L.chunked_attention(q, k, v, causal=True, window=window,
                              chunk_q=cq, chunk_kv=ck, scheme=scheme)
    grads = torch.autograd.grad((out * torch.tensor(w)).sum(), (q, k, v))
    return out.detach().numpy(), [g.numpy() for g in grads]


def test_tri_attention_is_the_references():
    # (b, s, h, kv, hd, window, chunk): causal, windowed, GQA
    # one input shape (4 heads over 2 KV heads), so the eager reference
    # compiles its ops once a chunk size
    for case in ((1, 64, 4, 2, 8, 0, 16), (1, 64, 4, 2, 8, 24, 16),
                 (1, 64, 4, 2, 8, 20, 16), (1, 64, 4, 2, 8, 0, 32),
                 (1, 64, 4, 2, 8, 40, 32)):
        b, s, h, kv, hd, window, c = case
        arrays = _inputs(sum(case), b, s, h, kv, hd)
        want, wgrads, w = _reference(arrays, "tri", window, c, c)
        got, grads = _port(arrays, "tri", window, c, c, w)
        np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=FWD_TOL,
                                   err_msg=str(case))
        for g, wg in zip(grads, wgrads):
            np.testing.assert_allclose(g, wg, atol=GRAD_TOL, rtol=GRAD_TOL,
                                       err_msg=str(case))
        rect, rgrads = _port(arrays, "rect", window, c, c, w)
        np.testing.assert_array_equal(got, rect)
        for g, rg in zip(grads, rgrads):
            np.testing.assert_allclose(g, rg, atol=GRAD_TOL, rtol=GRAD_TOL)
    # chunk_q != chunk_kv: the port's band is the rectangle's result, the
    # reference's tri is not (rows that differ, as ROADMAP.md §3 tabulates)
    for cq, ck, window, rows in ((32, 16, 0, 48), (32, 16, 24, 48),
                                 (16, 32, 0, 32)):
        arrays = _inputs(cq + ck + window, 1, 64, 4, 2, 8)
        w = np.ones(arrays[0].shape, np.float32)
        got, grads = _port(arrays, "tri", window, cq, ck, w)
        rect, rgrads = _port(arrays, "rect", window, cq, ck, w)
        np.testing.assert_array_equal(got, rect)
        for g, rg in zip(grads, rgrads):
            np.testing.assert_allclose(g, rg, atol=GRAD_TOL, rtol=GRAD_TOL)
        args = [jnp.asarray(a) for a in arrays]
        ref_rect, ref_tri = (np.asarray(_ref_attention(*args, scheme, window,
                                                       cq, ck))
                             for scheme in ("rect", "tri"))
        np.testing.assert_allclose(rect, ref_rect, atol=FWD_TOL,
                                   rtol=FWD_TOL)
        off = np.abs(ref_tri - ref_rect).max(axis=(0, 2, 3)) > 1e-4
        assert int(off.sum()) == rows, (cq, ck, window)


def _smoke_overrides(arch: str, **over) -> dict:
    """``run_cell``'s overrides that make the full config the smoke one."""
    full, smoke = get_config(arch), smoke_config(arch)
    out = {f.name: getattr(smoke, f.name) for f in dataclasses.fields(smoke)
           if getattr(smoke, f.name) != getattr(full, f.name)}
    return {**out, **over}


def test_the_tri_dry_run_counts_the_references_band():
    for arch in ("hymba-1.5b", "smollm-135m"):
        over = _smoke_overrides(arch, causal_scheme="tri")
        assert over["attn_chunk_q"] == over["attn_chunk_kv"] == 32
        if arch == "hymba-1.5b":
            assert over["window"] == 32
        got = {}
        for mode in ("prefill", "train"):
            rec = dryrun.run_cell(arch, ShapeConfig("t", 256, B, mode),
                                  "single", overrides=over, verbose=False)
            assert rec["status"] == "ok"
            assert rec["overrides"]["causal_scheme"] == "tri"
            got[mode] = rec["count"]
        want = reference_costs(arch, "prefill", causal_scheme="tri")
        assert got["prefill"] == want, arch
        assert got["prefill"]["flops"] < port_costs(arch, "prefill")["flops"]
        want = reference_costs(arch, "train", causal_scheme="tri")
        flops, nbytes = extra_work(arch, causal_scheme="tri")
        assert got["train"] == {"flops": want["flops"] + flops,
                                "dot_bytes": want["dot_bytes"] + nbytes}, arch
