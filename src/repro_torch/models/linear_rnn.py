"""Gated linear recurrences: RWKV6 (Finch) and Mamba2-style SSD (hymba's SSM
heads), the counterpart of ``repro.models.linear_rnn``.

Both are the decayed outer-product recurrence

    S_t = diag(decay_t) * S_{t-1} + k_t (x) v_t        out_t = q_t . S_t

with the decay on the K channels after reading the state plus a bonus u for
the current token (RWKV, mode "k"), or on the V channels before reading
(SSD, mode "v"). Prefill and training run the chunked form through the
CUDA kernels (``ops.rwkv6_scan``, ``ops.ssd_scan``) from the zero state; a
decode step runs the sequential form (``gla_ref``) in plain PyTorch, as the
reference does (``chunked=not decode``). Where a gradient is wanted, the
kernel's call goes through :class:`GlaScan`: the kernel forward, the
gradient of the reference's chunked form (:func:`gla_chunked_plain`)
backward, recomputed from the saved inputs in float64. The chunked form
divides by the chunk's cumulative decay Qs, and the gradient of v / Qs
holds v / Qs**2: in float32 that overflows once Qs falls below about 1e-19
(the reference's own gradient turns to inf and NaN there, its forward still
finite), in float64 only where the float32 forward itself fails.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import recompute_grads

DECAY_MIN = math.exp(-8.0)


# ----------------------------------------------------------- sequential refs
def gla_ref(q, k, v, decay, bonus=None, mode="k", s0=None):
    """Sequential oracle. q, k: (b, s, h, dk); v: (b, s, h, dv); decay:
    (b, s, h, dk) for mode "k", (b, s, h, dv) for mode "v"; bonus: (h, dk).
    Returns (out (b, s, h, dv) float32, state (b, h, dk, dv))."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    qf, kf, vf, w = (x.float() for x in (q, k, v, decay))
    state = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
             if s0 is None else s0)
    outs = []
    for t in range(s):
        qt, kt, vt, wt = qf[:, t], kf[:, t], vf[:, t], w[:, t]
        kv = kt[..., :, None] * vt[..., None, :]             # (b, h, dk, dv)
        if mode == "k":
            su = state + bonus[None, :, :, None] * kv if bonus is not None \
                else state
            outs.append(torch.einsum("bhk,bhkv->bhv", qt, su))
            state = state * wt[..., :, None] + kv
        else:
            state = state * wt[..., None, :] + kv
            outs.append(torch.einsum("bhk,bhkv->bhv", qt, state))
    return torch.stack(outs, dim=1), state


# ------------------------------------------------------------- chunked form
def _chunk(s: int, chunk: int) -> int:
    """The largest chunk up to ``chunk`` that divides ``s`` (odd prefills)."""
    c = min(chunk, s)
    while s % c:
        c -= 1
    return c


def _scaled(x, u):
    """x (b, c, h, k) * u (h, k): the first pair of the reference's
    ``einsum("bihk,hk,bihk->bhi")``. XLA lowers it as a dot_general with no
    contracted dimension, so on ``meta`` (the dry run) it is a batched
    product over (h, k) with a contraction of one, which the count reads as
    the reference's; elsewhere a multiply, the same values."""
    if not x.is_meta:
        return x * u
    b, c, h, k = x.shape
    out = torch.bmm(x.reshape(b * c, h * k).T[..., None],
                    u.reshape(h * k, 1, 1))
    return out[..., 0].T.reshape(b, c, h, k)


def gla_chunked_plain(q, k, v, decay, bonus=None, mode="k", chunk=64,
                      dtype=torch.float32):
    """The reference's chunked form (``repro.models.linear_rnn.gla_chunked``
    from the zero state) in plain PyTorch, in ``dtype`` (the reference's:
    float32): within a chunk dense products, across chunks the state.
    Layouts as ``gla_ref``; returns (out (b, s, h, dv), state (b, h, dk,
    dv)), both in ``dtype``."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    c = _chunk(s, chunk)
    n = s // c
    qf, kf, vf = (x.to(dtype).reshape(b, n, c, h, x.shape[-1])
                  for x in (q, k, v))
    wd = decay.to(dtype).reshape(b, n, c, h, decay.shape[-1])
    dev = q.device
    state = torch.zeros((b, h, dk, dv), dtype=dtype, device=dev)
    tri_lo = torch.tril(torch.ones((c, c), dtype=dtype, device=dev),
                        diagonal=-1)
    tri_inc = torch.tril(torch.ones((c, c), dtype=dtype, device=dev))
    eye = torch.eye(c, dtype=dtype, device=dev)
    outs = []
    # one unbind a tensor: its backward stacks the chunks' gradients once,
    # where an index a chunk would fill and add a whole-size gradient each
    for qc, kc, vc, wc in zip(*(x.unbind(1) for x in (qf, kf, vf, wd))):
        qs = torch.exp(torch.cumsum(torch.log(wc), dim=1))     # inclusive
        last = qs[:, -1]
        if mode == "k":
            r_t = qc * (qs / wc)                                # exclusive
            k_t = kc / qs
            a = torch.einsum("bihk,bjhk->bhij", r_t, k_t) * tri_lo
            if bonus is not None:
                qb = _scaled(qc, bonus.to(dtype))
                diag = torch.einsum("bihk,bihk->bhi", qb, kc)
                a = a + diag[..., None] * eye
            outs.append(torch.einsum("bihk,bhkv->bihv", r_t, state)
                        + torch.einsum("bhij,bjhv->bihv", a, vc))
            state = (state * last[..., None]
                     + torch.einsum("bjhk,bjhv->bhkv", last[:, None] * k_t,
                                    vc))
        else:
            bm = torch.einsum("bihk,bjhk->bhij", qc, kc) * tri_inc
            v_t = vc / qs
            outs.append(qs * (torch.einsum("bihk,bhkv->bihv", qc, state)
                              + torch.einsum("bhij,bjhv->bihv", bm, v_t)))
            state = last[:, :, None, :] * (
                state + torch.einsum("bjhk,bjhv->bhkv", kc, v_t))
    return torch.stack(outs, dim=1).reshape(b, s, h, dv), state


def _gla_kernel(q, k, v, decay, bonus=None, mode="k", chunk=64):
    """The chunked form through ``ops.rwkv6_scan`` (mode "k") or
    ``ops.ssd_scan`` (mode "v"); layouts as ``gla_ref``. Returns (out (b, s,
    h, dv) in q's dtype, state (b, h, dk, dv) float32). On ``meta`` (the
    dry run) it takes the reference's chunked form in float32
    (:func:`gla_chunked_plain`), whose products the count reads
    (``roofline/count.py``)."""
    if q.is_meta:
        out, state = gla_chunked_plain(q, k, v, decay, bonus, mode=mode,
                                       chunk=chunk)
        return out.to(q.dtype), state
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    c = _chunk(s, chunk)

    def flat(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, s, x.shape[-1])

    if mode == "k":
        out, state = ops.rwkv6_scan(flat(q), flat(k), flat(v), flat(decay),
                                    bonus, chunk=c)
    else:
        out, state = ops.ssd_scan(flat(q), flat(k), flat(v), flat(decay),
                                  chunk=c)
    return (out.reshape(b, h, s, dv).permute(0, 2, 1, 3),
            state.reshape(b, h, dk, dv))


class GlaScan(torch.autograd.Function):
    """:func:`_gla_kernel` forward, the gradient of
    :func:`gla_chunked_plain` in float64 at the same inputs backward (of
    the output and, where it is used, the final state)."""

    @staticmethod
    def forward(ctx, q, k, v, decay, bonus, mode: str, chunk: int):
        ctx.save_for_backward(q, k, v, decay, bonus)
        ctx.args = dict(mode=mode, chunk=chunk, dtype=torch.float64)
        ctx.set_materialize_grads(False)
        return _gla_kernel(q, k, v, decay, bonus, mode=mode, chunk=chunk)

    @staticmethod
    def backward(ctx, grad_out, grad_state):
        return recompute_grads(ctx, gla_chunked_plain, grad_out,
                                 grad_state) + (None, None)


def gla_chunked(q, k, v, decay, bonus=None, mode="k", chunk=64):
    """Chunked evaluation from the zero state through the CUDA kernel (the
    plain version on the CPU), at the chunk ``gla_chunked``'s divisor rule
    picks, through :class:`GlaScan`; layouts as ``gla_ref``. Returns (out
    (b, s, h, dv) in q's dtype, state (b, h, dk, dv) float32)."""
    return GlaScan.apply(q, k, v, decay, bonus, mode, chunk)


def gla_decode_step(q, k, v, decay, state, bonus=None, mode="k"):
    """Single-token recurrent step. q, k: (b, h, dk); v: (b, h, dv); decay
    per mode; state: (b, h, dk, dv)."""
    qf, kf, vf, w = (x.float() for x in (q, k, v, decay))
    kv = kf[..., :, None] * vf[..., None, :]
    if mode == "k":
        su = state + (bonus[None, :, :, None] * kv if bonus is not None
                      else 0.0)
        out = torch.einsum("bhk,bhkv->bhv", qf, su)
        state2 = state * w[..., :, None] + kv
    else:
        state2 = state * w[..., None, :] + kv
        out = torch.einsum("bhk,bhkv->bhv", qf, state2)
    return out, state2


# ------------------------------------------------------------------ RWKV6
def _token_shift(x, prev=None):
    """RWKV token shift: x_{t-1} (zeros / the supplied state at t = 0)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def rwkv_time_mix(p, x, cfg: ModelConfig, *, state=None, shift_prev=None,
                  chunked=True):
    """Returns (y, new_state, x_last). ``chunked`` (prefill) starts from the
    zero state and takes no ``state``; otherwise ``state`` (b, h, dk, dv)."""
    if chunked and state is not None:
        raise ValueError("rwkv_time_mix: the chunked prefill starts from the "
                         "zero state")
    b, s, d = x.shape
    xx = _token_shift(x, shift_prev)
    mu = p["mu"].to(x.dtype)
    xr = x + (xx - x) * mu[0]
    xk = x + (xx - x) * mu[1]
    xv = x + (xx - x) * mu[2]
    xw = x + (xx - x) * mu[3]
    xg = x + (xx - x) * mu[4]
    r = torch.einsum("bsd,dhk->bshk", xr, p["wr"])
    k = torch.einsum("bsd,dhk->bshk", xk, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", xv, p["wv"])
    g = torch.einsum("bsd,dhk->bshk", xg, p["wg"])
    # data-dependent decay (the Finch contribution)
    dd = torch.einsum("bsl,lhk->bshk",
                      torch.tanh(xw.float() @ p["wA"]), p["wB"])
    w = torch.exp(-torch.exp(torch.clamp(p["w0"][None, None] + dd, -8.0,
                                         2.0)))
    w = torch.clamp(w, min=DECAY_MIN)

    if chunked:
        out, new_state = gla_chunked(r, k, v, w, bonus=p["u"], mode="k",
                                     chunk=cfg.chunk_gla)
    else:
        out, new_state = gla_ref(r, k, v, w, bonus=p["u"], mode="k",
                                 s0=state)
    # per-head group norm in float32, then the output gate
    out = out.float()
    mean = torch.mean(out, dim=-1, keepdim=True)
    var = torch.var(out, dim=-1, keepdim=True, unbiased=False)
    out = (out - mean) * torch.rsqrt(var + 64e-5) * p["ln_x"][None, None]
    out = out.to(x.dtype) * F.silu(g)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, new_state, x[:, -1:]


def rwkv_channel_mix(p, x, shift_prev=None):
    xx = _token_shift(x, shift_prev)
    mu = p["mu"].to(x.dtype)
    xk = x + (xx - x) * mu[0]
    k = torch.square(torch.relu(xk @ p["wk"]))
    return k @ p["wv"], x[:, -1:]


# ------------------------------------------------- Mamba2-style SSD (hymba)
def ssd_mix(p, x, cfg: ModelConfig, *, state=None, chunked=True):
    """Returns (y, new_state); state (b, h, n, hd). ``chunked`` (prefill)
    starts from the zero state and takes no ``state``."""
    if chunked and state is not None:
        raise ValueError("ssd_mix: the chunked prefill starts from the zero "
                         "state")
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    xs = torch.einsum("bsd,dhk->bshk", x, p["wx"])                  # v
    bm = torch.einsum("bsd,dhn->bshn", x, p["wB"])                  # k
    cm = torch.einsum("bsd,dhn->bshn", x, p["wC"])                  # q
    dt = F.softplus(x.float() @ p["wdt"] + p["dt_bias"][None, None])  # (b,s,h)
    a = torch.exp(-dt * torch.exp(p["a_log"])[None, None])          # in (0, 1)
    a = torch.clamp(a, min=DECAY_MIN)
    v = xs.float() * dt[..., None]
    decay = a[..., None].expand(b, s, h, hd)                        # per v channel

    if chunked:
        out, new_state = gla_chunked(cm, bm, v.to(cm.dtype), decay, mode="v",
                                     chunk=cfg.chunk_gla)
    else:
        out, new_state = gla_ref(cm, bm, v.to(cm.dtype), decay, mode="v",
                                 s0=state)
    y = torch.einsum("bshk,hkd->bsd", out.to(x.dtype), p["wo"])
    return y, new_state
