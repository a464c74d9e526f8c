"""Shared neural layers of the model zoo: RMSNorm, RoPE, attention with a
KV cache (prefill through the flash-attention kernel, decode against the
ring cache), the gated MLP and the embeddings.

Counterpart of ``repro.models.layers``, with its names and layouts:
attention weights stay (d, heads, head_dim) for ``einsum``, activations
(batch, seq, heads, head_dim). Parameters are dict-like (the model's
``nn.ParameterDict``s). Not ported yet (ROADMAP.md): ``apply_m_rope`` (vlm),
``layernorm`` and cross-attention (encdec), and the attention without a
cache that training uses.
"""
from __future__ import annotations

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


# --------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs                 # (..., s, hd/2)
    cos = torch.cos(ang)[..., None, :]                         # (..., s, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


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


def attention(p, x, cfg: ModelConfig, *, positions, cache: KVCache):
    """Self-attention that serves the model: returns (y, cache).

    A prompt (seq > 1) is prefill: causal or sliding-window attention over
    the fresh K/V through ``ops.flash_attention``, then the last
    ``min(cache_len, seq)`` keys and values go into the cache. One token is
    decode: its K/V go into the ring slot ``length % cache_len`` (the
    oldest, once the ring is full) and it attends the valid slots in plain
    PyTorch, as the reference computes it outside any kernel. The cache's
    tensors (views into the model's stacked state) are written in place.
    """
    b, s, _ = x.shape
    q, k_new, v_new = _qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k_new = apply_rope(k_new, positions, cfg.rope_theta)
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
        h, hd = q.shape[2], q.shape[3]
        out = ops.flash_attention(_heads_first(q), _heads_first(k_new),
                                  _heads_first(v_new), causal=True,
                                  window=cfg.window)
        out = out.reshape(b, h, s, hd).permute(0, 2, 1, 3)
        keep = min(cache_len, s)
        cache.k[:, :keep] = k_new[:, s - keep:].to(cdt)
        cache.v[:, :keep] = v_new[:, s - keep:].to(cdt)
        cache.length.fill_(keep)
    y = torch.einsum("bshk,hkd->bsd", out.to(x.dtype), p["wo"])
    return y, cache


# ------------------------------------------------------------------- MLPs
def mlp(p, x):
    """The gated MLP of the served families (the reference's ungated one
    belongs to encdec, not ported yet)."""
    return (F.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]


# -------------------------------------------------------------- embeddings
def embed(p, tokens):
    return p["tok"][tokens]


def unembed(p, x):
    w = p["out"] if "out" in p else p["tok"].T
    return x @ w
