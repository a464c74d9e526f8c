"""Shared neural layers of the model zoo: RMSNorm and LayerNorm, RoPE and
Qwen2-VL's multimodal RoPE, attention (prefill, training and the encoder
through the flash-attention kernel, decode against the ring cache,
cross-attention over precomputed K/V), the gated and ungated MLPs and the
embeddings.

Where a gradient is wanted, the kernel's call goes through
:class:`FlashAttention`, an ``autograd.Function``: its forward launches the
kernel and keeps only the inputs, its backward recomputes the reference's
own training form, :func:`chunked_attention` (the online-softmax attention
of ``repro.models.layers._chunked_attention``), and differentiates that.

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


def _proj(p, x, cfg: ModelConfig, name: str):
    """x's projection by ``w{name}`` (plus ``b{name}`` where the config has
    biases)."""
    y = torch.einsum("bsd,dhk->bshk", x, p["w" + name])
    if cfg.use_bias:
        y = y + p["b" + name].to(y.dtype)
    return y


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """(b, s, h, d) -> (b * h, s, d): head h of batch row b at row b*h + h."""
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d)


def _decode_attention(q, k, v, valid, chunk_kv: int):
    """One query per row against the cache: q (b, 1, h, hd), k and v (b,
    cache_len, n_kv, hd) in the cache's dtype, the first ``valid`` slots
    attendable (in any order: RoPE is relative). Float32 softmax, GQA by
    head grouping h = kv * group + g. On ``meta`` (the dry run) the
    reference's chunked form over key chunks of ``chunk_kv``, whose
    products the count reads (``roofline/count.py``)."""
    if q.is_meta:
        return chunked_attention(q, k, v, causal=False, window=0, chunk_q=1,
                                 chunk_kv=chunk_kv, valid=valid)
    b, sq, h, hd = q.shape
    cl, n_kv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, n_kv, h // n_kv, hd)
    s = torch.einsum("bqngd,bknd->bngqk", qg, k.float()) * (1.0 / math.sqrt(hd))
    kpos = torch.arange(cl, device=q.device)
    s = s.masked_fill(~(kpos < valid), NEG_INF)
    out = torch.einsum("bngqk,bknd->bqngd", torch.softmax(s, dim=-1),
                       v.float())
    return out.reshape(b, sq, h, hd)


def _divisor_chunk(n: int, c: int) -> int:
    """The largest chunk up to ``c`` that divides ``n``."""
    c = min(c, n)
    while n % c:
        c -= 1
    return c


def chunked_attention(q, k, v, *, causal: bool, window: int, chunk_q: int,
                      chunk_kv: int, valid=None):
    """The reference's training attention (``_chunked_attention``, its
    rectangular scheme, no offset) in plain PyTorch: q (b, sq, h, hd) over
    k, v (b, skv, n_kv, hd), GQA by head grouping h = kv * group + g,
    float32 online softmax over key chunks, masked scores -1e30, the keys
    from ``valid`` on masked (default: every key valid). Returns (b, sq,
    h, hd) float32."""
    b, sq, h, hd = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    g = h // n_kv
    cq, ck = _divisor_chunk(sq, chunk_q), _divisor_chunk(skv, chunk_kv)
    n_q = sq // cq
    qr = q.float().reshape(b, n_q, cq, n_kv, g, hd)
    q_pos = torch.arange(sq, device=q.device).reshape(n_q, cq, 1)
    m = torch.full((b, n_q, n_kv, g, cq), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, n_q, n_kv, g, cq, hd), device=q.device)
    for lo, kb, vb in zip(range(0, skv, ck), k.float().split(ck, dim=1),
                          v.float().split(ck, dim=1)):
        s = torch.einsum("bqcngd,bknd->bqngck", qr, kb) * (1.0 / math.sqrt(hd))
        kpos = torch.arange(lo, lo + ck, device=q.device)
        if causal:
            mask = kpos <= q_pos                             # (n_q, cq, ck)
            if window > 0:
                mask = mask & (kpos > q_pos - window)
            s = torch.where(mask[None, :, None, None], s, NEG_INF)
        if valid is not None:
            s = s.masked_fill(~(kpos < valid), NEG_INF)
        m2 = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m2[..., None])
        corr = torch.exp(m - m2)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqngck,bknd->bqngcd", p,
                                                   vb)
        m = m2
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.permute(0, 1, 4, 2, 3, 5).reshape(b, sq, h, hd)


def _flash(q, k, v, *, causal: bool, window: int = 0, chunk_q: int,
           chunk_kv: int):
    """(b, sq, h, hd) queries over (b, skv, n_kv, hd) keys and values
    through ``ops.flash_attention``; returns (b, sq, h, hd). On ``meta``
    (the dry run) it takes the reference's chunked form, whose products
    the count reads (``roofline/count.py``)."""
    if q.is_meta:
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 chunk_q=chunk_q, chunk_kv=chunk_kv).to(
                                     q.dtype)
    b, sq, h, hd = q.shape
    out = ops.flash_attention(_heads_first(q), _heads_first(k),
                              _heads_first(v), causal=causal, window=window)
    return out.reshape(b, h, sq, hd).permute(0, 2, 1, 3)


class FlashAttention(torch.autograd.Function):
    """:func:`_flash` forward (the kernel on the card), the gradient of
    :func:`chunked_attention` at the same inputs backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, chunk_q: int,
                chunk_kv: int):
        ctx.save_for_backward(q, k, v)
        ctx.args = dict(causal=causal, window=window, chunk_q=chunk_q,
                        chunk_kv=chunk_kv)
        return _flash(q, k, v, causal=causal, window=window,
                      chunk_q=chunk_q, chunk_kv=chunk_kv)

    @staticmethod
    def backward(ctx, grad):
        return recompute_grads(ctx, chunked_attention, grad) + (None,) * 4


def recompute_grads(ctx, fn, *grads) -> tuple:
    """The gradients of ``fn(*saved inputs, **ctx.args)`` for the inputs
    that want one (None for the rest): ``fn`` is run again under autograd
    and differentiated against ``grads`` (None: that output unused)."""
    saved = ctx.saved_tensors
    want = ctx.needs_input_grad[:len(saved)]
    with torch.enable_grad():
        ins = [x.detach().requires_grad_(w) if x is not None else None
               for x, w in zip(saved, want)]
        outs = fn(*ins, **ctx.args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g.to(o.dtype)) for o, g in zip(outs, grads)
                 if g is not None]
        leaves = [x for x, w in zip(ins, want) if w]
        got = iter(torch.autograd.grad([o for o, _ in pairs], leaves,
                                       [g for _, g in pairs])
                   if leaves else ())
    return tuple(next(got) if w else None for w in want)


def attention(p, x, cfg: ModelConfig, *, positions, causal: bool = True,
              cache: KVCache | None = None, cross_kv=None):
    """The reference's attention entry point: returns (y, cache).

    Three modes, as the reference's. (a) No cache and no ``cross_kv``: self
    attention over x (training; whisper's encoder, ``causal=False``), RoPE
    applied, through ``ops.flash_attention`` (:class:`FlashAttention`). (b)
    With a cache: a prompt (seq > 1) is prefill: causal or sliding-window
    attention over the fresh K/V through the kernel, then the last
    ``min(cache_len, seq)`` keys and values go into the cache; one token is
    decode: its K/V go into the ring slot ``length % cache_len`` (the
    oldest, once the ring is full) and it attends the valid slots in plain
    PyTorch, as the reference computes it outside any kernel. The cache's
    tensors (views into the model's stacked state) are written in place.
    (c) ``cross_kv=(k, v)``: cross-attention of q (its bias included, no
    RoPE) over every precomputed key, through the kernel (non-causal) for a
    prompt, in plain PyTorch for one token; x's own K and V are not
    projected (the reference projects them, and XLA drops the unused
    products). On ``meta`` (the dry run) every attention takes the
    reference's chunked form (:func:`chunked_attention`), whose products
    the count reads.
    """
    b, s, _ = x.shape
    q = _proj(p, x, cfg, "q")
    if cross_kv is not None:   # K and V are the encoder's: no projection
        k, v = cross_kv
        if s == 1:
            out = _decode_attention(q, k, v, k.shape[1], cfg.attn_chunk_kv)
        else:
            out = FlashAttention.apply(q, k, v, False, 0, cfg.attn_chunk_q,
                                       cfg.attn_chunk_kv)
        return torch.einsum("bshk,hkd->bsd", out.to(x.dtype), p["wo"]), cache
    q = _rope(q, positions, cfg)
    k_new = _rope(_proj(p, x, cfg, "k"), positions, cfg)
    v_new = _proj(p, x, cfg, "v")
    if cache is None:
        out = FlashAttention.apply(q, k_new, v_new, causal, cfg.window,
                                   cfg.attn_chunk_q, cfg.attn_chunk_kv)
    elif s == 1:
        cache_len, cdt = cache.k.shape[1], cache.k.dtype
        widx = (cache.length % cache_len).long().reshape(1)
        cache.k.index_copy_(1, widx, k_new.to(cdt))
        cache.v.index_copy_(1, widx, v_new.to(cdt))
        valid = torch.clamp(cache.length + 1, max=cache_len)
        cache.length.add_(1)
        out = _decode_attention(q, cache.k, cache.v, valid,
                                cfg.attn_chunk_kv)
    else:
        out = _flash(q, k_new, v_new, causal=True, window=cfg.window,
                     chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv)
        keep = min(cache.k.shape[1], s)
        cache.k[:, :keep] = k_new[:, s - keep:].to(cache.k.dtype)
        cache.v[:, :keep] = v_new[:, s - keep:].to(cache.v.dtype)
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
