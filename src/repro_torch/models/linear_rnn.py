"""Gated linear recurrences: RWKV6 (Finch) and Mamba2-style SSD (hymba's SSM
heads), the counterpart of ``repro.models.linear_rnn``.

Both are the decayed outer-product recurrence

    S_t = diag(decay_t) * S_{t-1} + k_t (x) v_t        out_t = q_t . S_t

with the decay on the K channels after reading the state plus a bonus u for
the current token (RWKV, mode "k"), or on the V channels before reading
(SSD, mode "v"). Prefill runs the chunked form through the CUDA kernels
(``ops.rwkv6_scan``, ``ops.ssd_scan``) from the zero state; a decode step
runs the sequential form (``gla_ref``) in plain PyTorch, as the reference
does (``chunked=not decode``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

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


def gla_chunked(q, k, v, decay, bonus=None, mode="k", chunk=64):
    """Chunked evaluation from the zero state through the CUDA kernel (the
    plain version on the CPU), at the chunk ``gla_chunked``'s divisor rule
    picks; layouts as ``gla_ref``. Returns (out (b, s, h, dv) in q's dtype,
    state (b, h, dk, dv) float32)."""
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
