"""The model zoo's serving model, the counterpart of ``repro.models.model``
for all six families: ``dense``, ``moe`` (top-k experts, with leading
dense layers for moonshot), ``hybrid`` (hymba: attention and SSD heads side
by side), ``ssm`` (RWKV6), ``vlm`` (qwen2-vl: multimodal RoPE, patch
embeddings written over the first positions) and ``encdec`` (whisper: an
encoder over the frames, a decoder with cross-attention).

``Model`` is an ``nn.Module`` that holds its parameters under the
reference's tree paths (``embed.tok``, ``layers.{i}.attn.wq``,
``first_layers.{i}...``, ``encoder.{i}...``; the reference stacks the
layers on a leading axis, the port keeps one module per layer) and exposes

  init(generator)                   random weights at the published shapes
  prefill_fn(batch)                 -> (last-token logits (b, vocab) float32,
                                        decode state)
  decode_fn(state, tokens, length)  -> (logits, state)

``batch`` holds ``tokens`` (b, s), and ``frames`` (b, S, d) for encdec,
optionally ``patch_embeds`` (b, P, d) and ``positions3`` (3, b, s) for vlm.
The decode state keeps the reference's structure: ``kv``, one ``KVCache``
whose tensors stack the layers on a leading axis; ``kv_first`` for the
leading dense layers of a moe model; ``rnn``, a dict of stacked recurrent
states (``ssd`` for hybrid; ``S``, ``tm_prev``, ``cm_prev`` for ssm); and
for encdec ``cross``, the stacked cross-attention K and V of the encoder's
output, in place of ``rnn``. Prefill allocates it; each layer writes its
slice in place, and ``decode_fn`` updates it in place (the reference
returns a new tree), which saves a copy of the cache per token. The
reference's ``lax.scan`` over layers is a loop over the module lists. Not
ported yet (ROADMAP.md): ``loss_fn``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import linear_rnn as R
from repro_torch.models import moe as M

_F32 = torch.float32


# ======================================================================== init
def _dense(shape, dtype, scale=None):
    """A ``dense_init`` leaf: normal * (scale or 1/sqrt(shape[0]))."""
    return shape, dtype, ("normal", scale if scale is not None
                          else 1.0 / math.sqrt(shape[0]))


def _fill(shape, value):
    return shape, _F32, ("fill", value)


def _attention_spec(cfg: ModelConfig, dt):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    p = {"wq": _dense((d, h, hd), dt), "wk": _dense((d, kv, hd), dt),
         "wv": _dense((d, kv, hd), dt),
         "wo": _dense((h, hd, d), dt, 1.0 / math.sqrt(h * hd))}
    if cfg.use_bias:
        p.update(bq=_fill((h, hd), 0.0), bk=_fill((kv, hd), 0.0),
                 bv=_fill((kv, hd), 0.0))
    return p


def _mlp_spec(cfg: ModelConfig, dt, d_ff: int | None = None, gated=True):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {"wi": _dense((d, f), dt), "wo": _dense((f, d), dt)}
    if gated:
        p["wg"] = _dense((d, f), dt)
    return p


def _block_spec(cfg: ModelConfig, kind: str) -> dict:
    """One block's leaves: name -> (shape, dtype, init), or a dict of them
    for a sub-layer; the reference's ``_init_block`` leaf for leaf. Kinds:
    dense, moe, dense_ffn_moe_arch (a moe model's leading dense layers),
    hybrid, rwkv, enc and dec."""
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    dt = L.dtype_of(cfg)
    norm = _fill((d,), 1.0)
    if kind == "rwkv":
        lora = 64
        return {
            "ln1": norm,
            "tmix": {
                "mu": _fill((5, d), 0.5),
                "wr": _dense((d, h, hd), dt), "wk": _dense((d, h, hd), dt),
                "wv": _dense((d, h, hd), dt), "wg": _dense((d, h, hd), dt),
                "wo": _dense((h, hd, d), dt, 1.0 / math.sqrt(d)),
                "w0": _fill((h, hd), -2.0),
                "wA": _dense((d, lora), _F32, 0.01),
                "wB": _dense((lora, h, hd), _F32, 0.01),
                "u": _fill((h, hd), 0.0),
                "ln_x": _fill((h, hd), 1.0)},
            "ln2": norm,
            "cmix": {"mu": _fill((2, d), 0.5),
                     "wk": _dense((d, cfg.d_ff), dt),
                     "wv": _dense((cfg.d_ff, d), dt)}}
    p = {"ln1": norm, "attn": _attention_spec(cfg, dt), "ln2": norm}
    if kind == "hybrid":
        n = cfg.ssm_state
        p["ssd"] = {"wx": _dense((d, h, hd), dt), "wB": _dense((d, h, n), dt),
                    "wC": _dense((d, h, n), dt),
                    "wdt": _dense((d, h), _F32, 0.01),
                    "a_log": _fill((h,), 0.0),
                    "wo": _dense((h, hd, d), dt, 1.0 / math.sqrt(d)),
                    "dt_bias": _fill((h,), -1.0)}
        p["ln_attn_out"] = norm
        p["ln_ssd_out"] = norm
    if kind == "moe":
        p["moe"] = M.init_moe(cfg, dt)
    elif kind == "dense_ffn_moe_arch":
        p["mlp"] = _mlp_spec(cfg, dt, d_ff=4 * d)
    elif kind in ("enc", "dec"):
        zero = _fill((d,), 0.0)
        if kind == "dec":
            p["xattn"] = _attention_spec(cfg, dt)
            p["ln3"] = norm
            p["lnb3"] = zero
        p["lnb1"] = zero
        p["lnb2"] = zero
        p["mlp"] = _mlp_spec(cfg, dt, gated=False)
    else:
        p["mlp"] = _mlp_spec(cfg, dt)
    return p


def _block_kind(cfg: ModelConfig) -> str:
    return {"dense": "dense", "vlm": "dense", "moe": "moe",
            "hybrid": "hybrid", "ssm": "rwkv", "encdec": "dec"}[cfg.family]


class _Leaves(nn.Module):
    """Parameters of one tree level: a leaf is an ``nn.Parameter``, a
    sub-layer an ``nn.ParameterDict`` (read as ``p["wq"]``)."""

    def __init__(self, spec: dict, device, rules: dict, prefix: str):
        super().__init__()

        def param(name, leaf):
            shape, dtype, rule = leaf
            rules[prefix + name] = rule
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                                requires_grad=False)

        for name, leaf in spec.items():
            if isinstance(leaf, dict):
                setattr(self, name, nn.ParameterDict(
                    {k: param(f"{name}.{k}", v) for k, v in leaf.items()}))
            else:
                setattr(self, name, param(name, leaf))


# ================================================================= block apply
def _apply_block(p, x, cfg: ModelConfig, kind: str, *, positions, cache=None,
                 cross_kv=None, rnn_state=None, decode=False):
    """Returns (x, cache, new_rnn_state). Prefill (``decode`` False) starts
    the recurrences from the zero state; decode continues ``rnn_state``.
    The moe layer's auxiliary loss is dropped: serving does not read it."""
    if kind == "rwkv":
        st = rnn_state if decode else {}
        h = L.rmsnorm(x, p.ln1, cfg.norm_eps)
        y, s2, tm_last = R.rwkv_time_mix(
            p.tmix, h, cfg, state=st.get("S"), shift_prev=st.get("tm_prev"),
            chunked=not decode)
        x = x + y
        h = L.rmsnorm(x, p.ln2, cfg.norm_eps)
        y, cm_last = R.rwkv_channel_mix(p.cmix, h,
                                        shift_prev=st.get("cm_prev"))
        return x + y, cache, {"S": s2, "tm_prev": tm_last, "cm_prev": cm_last}

    if kind in ("enc", "dec"):
        h = L.layernorm(x, p.ln1, p.lnb1, cfg.norm_eps)
        y, cache = L.attention(p.attn, h, cfg, positions=positions,
                               causal=kind == "dec", cache=cache)
        x = x + y
        if kind == "dec":
            h = L.layernorm(x, p.ln3, p.lnb3, cfg.norm_eps)
            x = x + L.attention(p.xattn, h, cfg, positions=positions,
                                cross_kv=cross_kv)[0]
        h = L.layernorm(x, p.ln2, p.lnb2, cfg.norm_eps)
        return x + L.mlp(p.mlp, h), cache, None

    new_rnn = None
    h = L.rmsnorm(x, p.ln1, cfg.norm_eps)
    attn_y, cache = L.attention(p.attn, h, cfg, positions=positions,
                                cache=cache)
    if kind == "hybrid":
        ssd_y, s2 = R.ssd_mix(p.ssd, h, cfg,
                              state=rnn_state["ssd"] if decode else None,
                              chunked=not decode)
        # hymba: normalize both heads' outputs, then average
        y = 0.5 * (L.rmsnorm(attn_y, p.ln_attn_out, cfg.norm_eps)
                   + L.rmsnorm(ssd_y, p.ln_ssd_out, cfg.norm_eps))
        new_rnn = {"ssd": s2}
    else:
        y = attn_y
    x = x + y
    h = L.rmsnorm(x, p.ln2, cfg.norm_eps)
    y = M.moe_ffn(p.moe, h, cfg)[0] if kind == "moe" else L.mlp(p.mlp, h)
    return x + y, cache, new_rnn


# ==================================================================== Model
class Model(nn.Module):
    """A served model of one config, on ``device`` (the CUDA card unless
    told otherwise; ``"meta"`` gives shapes without memory)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self._rules: dict[str, tuple] = {}
        d, dt = cfg.d_model, L.dtype_of(cfg)
        emb = {"tok": _dense((cfg.vocab, d), dt, 1.0 / math.sqrt(d))}
        if not cfg.tie_embeddings:
            emb["out"] = _dense((d, cfg.vocab), dt, 1.0 / math.sqrt(d))
        top = {"embed": emb, "final_norm": _fill((d,), 1.0)}
        if cfg.family == "encdec":
            top.update(enc_norm=_fill((d,), 1.0), enc_normb=_fill((d,), 0.0))
        if cfg.family == "vlm":
            top["patch_proj"] = _dense((d, d), dt)
        top = _Leaves(top, self.device, self._rules, "")
        for name, leaf in (*top.named_children(),
                           *top.named_parameters(recurse=False)):
            setattr(self, name, leaf)

        def stack(name, kind, n):
            return nn.ModuleList(
                _Leaves(_block_spec(cfg, kind), self.device, self._rules,
                        f"{name}.{i}.") for i in range(n))

        if cfg.moe_first_dense:
            self.first_layers = stack("first_layers", "dense_ffn_moe_arch",
                                      cfg.moe_first_dense)
        self.layers = stack("layers", _block_kind(cfg),
                            cfg.n_layers - cfg.moe_first_dense)
        if cfg.family == "encdec":
            self.encoder = stack("encoder", "enc", cfg.encoder_layers)

    # ----------------------------------------------------------------- init
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Random weights at the config's shapes, drawn from ``generator``
        on its own device (a CUDA generator draws on the card), in the
        reference's per-leaf scales and fills."""
        for name, p in self.named_parameters():
            kind, value = self._rules[name]
            if kind == "fill":
                p.fill_(value)
            else:
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=generator.device) * value)
        return self

    # ------------------------------------------------------------- embedding
    def _embed_inputs(self, batch: dict, tokens):
        """Token embeddings; for vlm, ``patch_embeds`` (b, P, d) projected by
        ``patch_proj`` and written over the first P positions."""
        x = L.embed(self.embed, tokens)
        if self.cfg.family == "vlm" and "patch_embeds" in batch:
            pe = torch.as_tensor(batch["patch_embeds"], device=self.device)
            n_patch = pe.shape[1]
            if n_patch > x.shape[1]:
                raise ValueError(f"{n_patch} patch embeddings for "
                                 f"{x.shape[1]} positions")
            x[:, :n_patch] = torch.einsum("bpd,de->bpe", pe.to(x.dtype),
                                          self.patch_proj)
        return x

    def _positions(self, batch: dict, b: int, s: int):
        """(b, s) positions, or (3, b, s) for multimodal RoPE:
        ``positions3`` if given, else the same positions three times."""
        if self.cfg.m_rope and "positions3" in batch:
            return torch.as_tensor(batch["positions3"],
                                   device=self.device).long()
        pos = torch.arange(s, device=self.device)[None].expand(b, s)
        return torch.stack([pos] * 3) if self.cfg.m_rope else pos

    # ------------------------------------------------------------- encoders
    def _encode(self, batch: dict):
        """Whisper's encoder over ``frames`` (b, S, d): the frames in the
        model's dtype plus sinusoidal positions, the encoder layers, the
        final LayerNorm."""
        cfg = self.cfg
        frames = torch.as_tensor(batch["frames"], device=self.device).to(
            L.dtype_of(cfg))
        b, s, d = frames.shape
        x = frames + L.sinusoid_positions(s, d, self.device).to(frames.dtype)
        pos = torch.arange(s, device=self.device)[None].expand(b, s)
        x = self._run(self.encoder, "enc", x, pos)
        return L.layernorm(x, self.enc_norm, self.enc_normb, cfg.norm_eps)

    def _cross_kv(self, enc_out):
        """Each decoder layer's cross-attention K and V of the encoder's
        output, stacked (n_layers, b, S, n_kv, hd). No bias, as the
        reference's (its ``_qkv`` bias applies to q only)."""
        ks, vs = zip(*((torch.einsum("bsd,dhk->bshk", enc_out, p.xattn["wk"]),
                        torch.einsum("bsd,dhk->bshk", enc_out, p.xattn["wv"]))
                       for p in self.layers))
        return torch.stack(ks), torch.stack(vs)

    # --------------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill_fn(self, batch: dict):
        """Forward over the prompt ``batch["tokens"]`` (b, s) with cache
        writes; returns (last-token logits (b, vocab) float32, state)."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        b, s = tokens.shape
        pos = self._positions(batch, b, s)
        if cfg.family == "encdec":
            cross = self._cross_kv(self._encode(batch))
            caches = self._self_caches(b, cfg.decoder_len)
            x = self._run(self.layers, "dec", L.embed(self.embed, tokens),
                          pos, caches, cross=cross)
            return self._logits(x[:, -1:]), {"kv": caches, "cross": cross}
        x = self._embed_inputs(batch, tokens)
        state = {}
        if cfg.moe_first_dense:
            state["kv_first"] = self._self_caches(b, self._cache_len(s),
                                                  n=cfg.moe_first_dense)
            x = self._run(self.first_layers, "dense_ffn_moe_arch", x, pos,
                          state["kv_first"])
        caches, rnn = self._inner_state(b, self._cache_len(s))
        x = self._run(self.layers, _block_kind(cfg), x, pos, caches, rnn)
        state.update(kv=caches, rnn=rnn)
        return self._logits(x[:, -1:]), state

    # ---------------------------------------------------------------- decode
    @torch.no_grad()
    def decode_fn(self, state: dict, tokens, length: int):
        """One token for every sequence: tokens (b, 1) at position
        ``length``. Updates ``state`` in place and returns (logits,
        state)."""
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device).long()
        b = tokens.shape[0]
        x = L.embed(self.embed, tokens)
        pos = torch.full((b, 1), int(length), device=self.device)
        if cfg.m_rope:
            pos = torch.stack([pos] * 3)
        if cfg.family == "encdec":
            x = self._run(self.layers, "dec", x, pos, state["kv"],
                          cross=state["cross"], decode=True)
            return self._logits(x), state
        if cfg.moe_first_dense:
            x = self._run(self.first_layers, "dense_ffn_moe_arch", x, pos,
                          state["kv_first"], decode=True)
        x = self._run(self.layers, _block_kind(cfg), x, pos, state["kv"],
                      state["rnn"], decode=True)
        return self._logits(x), state

    def _run(self, layers, kind: str, x, pos, caches=None, rnn=None, *,
             cross=None, decode: bool = False):
        """The layers in order, layer i on slice i of the stacked caches,
        recurrent states and cross K/V."""
        for i, p in enumerate(layers):
            cache = None if caches is None else L.KVCache(
                caches.k[i], caches.v[i], caches.length[i])
            rnn_i = None if rnn is None else {k: v[i] for k, v in rnn.items()}
            x, _, new_rnn = _apply_block(
                p, x, self.cfg, kind, positions=pos, cache=cache,
                cross_kv=None if cross is None else (cross[0][i], cross[1][i]),
                rnn_state=rnn_i, decode=decode)
            if rnn is not None:
                for k, v in new_rnn.items():
                    rnn[k][i].copy_(v)
        return x

    def _logits(self, x):
        x = L.rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        logits = L.unembed(self.embed, x.to(L.dtype_of(self.cfg)))
        return logits[:, 0].float()

    # ------------------------------------------------------- state factories
    def _cache_len(self, seq: int) -> int:
        cfg = self.cfg
        if cfg.family == "ssm":
            return 0
        base = seq + cfg.cache_headroom
        if cfg.window > 0:
            return min(cfg.window, base)
        return base

    def _self_caches(self, b: int, cache_len: int, n: int | None = None):
        """Zeroed caches of ``n`` layers (default: the main stack's,
        ``n_layers - moe_first_dense``)."""
        cfg = self.cfg
        n = cfg.n_layers - cfg.moe_first_dense if n is None else n
        shape = (n, b, cache_len, cfg.n_kv, cfg.head_dim)
        dt = L.cache_dtype(cfg)
        return L.KVCache(
            k=torch.zeros(shape, dtype=dt, device=self.device),
            v=torch.zeros(shape, dtype=dt, device=self.device),
            length=torch.zeros((n,), dtype=torch.int32, device=self.device))

    def _inner_state(self, b: int, cache_len: int):
        cfg = self.cfg
        kind = _block_kind(cfg)
        n = cfg.n_layers - cfg.moe_first_dense
        caches, rnn = None, None
        if kind in ("dense", "moe", "hybrid"):
            caches = self._self_caches(b, cache_len)
        if kind == "hybrid":
            rnn = {"ssd": torch.zeros((n, b, cfg.n_heads, cfg.ssm_state,
                                       cfg.head_dim), dtype=_F32,
                                      device=self.device)}
        elif kind == "rwkv":
            d, dt = cfg.d_model, L.dtype_of(cfg)
            rnn = {
                "S": torch.zeros((n, b, cfg.n_heads, cfg.head_dim,
                                  cfg.head_dim), dtype=_F32,
                                 device=self.device),
                "tm_prev": torch.zeros((n, b, 1, d), dtype=dt,
                                       device=self.device),
                "cm_prev": torch.zeros((n, b, 1, d), dtype=dt,
                                       device=self.device),
            }
        return caches, rnn


def build_model(cfg: ModelConfig, device=None) -> Model:
    return Model(cfg, device)
