"""Shared neural layers of the model zoo: RMSNorm and LayerNorm, RoPE and
Qwen2-VL's multimodal RoPE, attention (prefill and the encoder through the
flash-attention kernel, decode against the ring cache, cross-attention
over precomputed K/V), the gated and ungated MLPs and the embeddings.

Counterpart of ``repro.models.layers``, with its names and layouts:
attention weights stay (d, heads, head_dim) for ``einsum``, activations
(batch, seq, heads, head_dim). Parameters are dict-like (the model's
``nn.ParameterDict``s).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

NEG_INF = -1e30


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ------------------------------------------------------------------ RMSNorm
def rmsnorm(x, gamma, eps):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * gamma.to(x.dtype)


def layernorm(x, gamma, beta, eps):
    """LayerNorm over the last axis in float32 (the population variance, as
    ``jnp.var``), scaled and shifted in x's dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * gamma.to(x.dtype) + beta.to(x.dtype)


# --------------------------------------------------------------------- RoPE
@functools.lru_cache(maxsize=16)
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """theta^(-2i / head_dim), taken on the CPU in float32 as the reference
    takes it, then moved to ``device`` (cached per device): the card's
    float32 ``pow`` can differ from the CPU's in the last bit, which moves
    an angle at position 1,000 by about 1e-4 rad."""
    return (1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32)
                             / head_dim))).to(device)


@functools.lru_cache(maxsize=8)
def sinusoid_positions(s: int, d: int, device=None) -> torch.Tensor:
    """Whisper's sinusoidal position table (s, d), taken on the CPU in
    float32 as the reference takes it, then moved to ``device`` (cached per
    device), so the card and the CPU add the same table: at 1,500 positions
    a last-bit change of a frequency moves an angle by about 1e-4 rad."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32) / max(half - 1, 1))
    ang = torch.arange(s, dtype=torch.float32)[:, None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs                 # (..., s, hd/2)
    return _rotate(x, ang)


def apply_m_rope(x: torch.Tensor, positions3: torch.Tensor,
                 theta: float) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE: positions3 (3, ..., seq) = (temporal,
    height, width) rotate the half head dim's frequencies split 2:1:1."""
    half = x.shape[-1] // 2
    s_t = half // 2
    s_h = (half - s_t) // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = torch.cat([positions3[i][..., None].float() * freqs[lo:hi]
                     for i, (lo, hi) in enumerate(
                         ((0, s_t), (s_t, s_t + s_h), (s_t + s_h, half)))],
                    dim=-1)
    return _rotate(x, ang)


def _rotate(x, ang):
    """x (..., s, heads, hd) rotated by the angles (..., s, hd/2)."""
    cos = torch.cos(ang)[..., None, :]                         # (..., s, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _rope(x, positions, cfg: ModelConfig):
    if cfg.m_rope:
        return apply_m_rope(x, positions, cfg.rope_theta)
    return apply_rope(x, positions, cfg.rope_theta)


# -------------------------------------------------------------- attention
class KVCache(NamedTuple):
    k: torch.Tensor       # (batch, cache_len, n_kv, head_dim), cache_dtype
    v: torch.Tensor
    length: torch.Tensor  # int32 scalar: tokens written so far


def cache_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.kv_dtype) if cfg.kv_dtype else dtype_of(cfg)


def _qkv(p, x, cfg: ModelConfig):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.use_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    return q, k, v


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """(b, s, h, d) -> (b * h, s, d): head h of batch row b at row b*h + h."""
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d)


def _decode_attention(q, k, v, valid):
    """One query per row against the cache: q (b, 1, h, hd), k and v (b,
    cache_len, n_kv, hd) in the cache's dtype, the first ``valid`` slots
    attendable (in any order: RoPE is relative). Float32 softmax, GQA by
    head grouping h = kv * group + g."""
    b, sq, h, hd = q.shape
    cl, n_kv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, n_kv, h // n_kv, hd)
    s = torch.einsum("bqngd,bknd->bngqk", qg, k.float()) * (1.0 / math.sqrt(hd))
    kpos = torch.arange(cl, device=q.device)
    s = s.masked_fill(~(kpos < valid), NEG_INF)
    out = torch.einsum("bngqk,bknd->bqngd", torch.softmax(s, dim=-1),
                       v.float())
    return out.reshape(b, sq, h, hd)


def _flash(q, k, v, *, causal: bool, window: int = 0):
    """(b, sq, h, hd) queries over (b, skv, n_kv, hd) keys and values
    through ``ops.flash_attention``; returns (b, sq, h, hd)."""
    b, sq, h, hd = q.shape
    out = ops.flash_attention(_heads_first(q), _heads_first(k),
                              _heads_first(v), causal=causal, window=window)
    return out.reshape(b, h, sq, hd).permute(0, 2, 1, 3)


def attention(p, x, cfg: ModelConfig, *, positions, causal: bool = True,
              cache: KVCache | None = None, cross_kv=None):
    """The reference's attention entry point: returns (y, cache).

    Three modes, as the reference's. (a) No cache and no ``cross_kv``: self
    attention over x (whisper's encoder, ``causal=False``), RoPE applied,
    through ``ops.flash_attention``. (b) With a cache: a prompt (seq > 1)
    is prefill: causal or sliding-window attention over the fresh K/V
    through the kernel, then the last ``min(cache_len, seq)`` keys and
    values go into the cache; one token is decode: its K/V go into the ring
    slot ``length % cache_len`` (the oldest, once the ring is full) and it
    attends the valid slots in plain PyTorch, as the reference computes it
    outside any kernel. The cache's tensors (views into the model's stacked
    state) are written in place. (c) ``cross_kv=(k, v)``: cross-attention
    of q (its bias included, no RoPE) over every precomputed key, through
    the kernel (non-causal) for a prompt, in plain PyTorch for one token.
    """
    b, s, _ = x.shape
    q, k_new, v_new = _qkv(p, x, cfg)
    if cross_kv is not None:
        k, v = cross_kv
        if s == 1:
            out = _decode_attention(q, k, v, k.shape[1])
        else:
            out = _flash(q, k, v, causal=False)
    elif cache is None:
        out = _flash(_rope(q, positions, cfg), _rope(k_new, positions, cfg),
                     v_new, causal=causal, window=cfg.window)
    else:
        q = _rope(q, positions, cfg)
        k_new = _rope(k_new, positions, cfg)
        cache_len = cache.k.shape[1]
        cdt = cache.k.dtype
        if s == 1:
            widx = (cache.length % cache_len).long().reshape(1)
            cache.k.index_copy_(1, widx, k_new.to(cdt))
            cache.v.index_copy_(1, widx, v_new.to(cdt))
            valid = torch.clamp(cache.length + 1, max=cache_len)
            cache.length.add_(1)
            out = _decode_attention(q, cache.k, cache.v, valid)
        else:
            out = _flash(q, k_new, v_new, causal=True, window=cfg.window)
            keep = min(cache_len, s)
            cache.k[:, :keep] = k_new[:, s - keep:].to(cdt)
            cache.v[:, :keep] = v_new[:, s - keep:].to(cdt)
            cache.length.fill_(keep)
    y = torch.einsum("bshk,hkd->bsd", out.to(x.dtype), p["wo"])
    return y, cache


# ------------------------------------------------------------------- MLPs
def mlp(p, x):
    """The gated MLP (SiLU), or the ungated one (tanh-approximated GELU, as
    ``jax.nn.gelu``'s default) where there is no ``wg`` (encdec)."""
    h = x @ p["wi"]
    if "wg" in p:
        h = F.silu(x @ p["wg"]) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p["wo"]


# -------------------------------------------------------------- embeddings
def embed(p, tokens):
    return p["tok"][tokens]


def unembed(p, x):
    w = p["out"] if "out" in p else p["tok"].T
    return x @ w
