"""The model zoo's serving model, the counterpart of ``repro.models.model``
for the families that serve through the same block stack: ``dense``,
``hybrid`` (hymba: attention and SSD heads side by side) and ``ssm``
(RWKV6).

``Model`` is an ``nn.Module`` that holds its parameters under the
reference's tree paths (``embed.tok``, ``layers.{i}.attn.wq``, ...; the
reference stacks the layers on a leading axis, the port keeps one module per
layer) and exposes

  init(generator)                   random weights at the published shapes
  prefill_fn(batch)                 -> (last-token logits (b, vocab) float32,
                                        decode state)
  decode_fn(state, tokens, length)  -> (logits, state)

The decode state keeps the reference's structure: ``kv``, one ``KVCache``
whose tensors stack the layers on a leading axis, and ``rnn``, a dict of
stacked recurrent states (``ssd`` for hybrid; ``S``, ``tm_prev``,
``cm_prev`` for ssm). Prefill allocates it; each layer writes its slice in
place, and ``decode_fn`` updates it in place (the reference returns a new
tree), which saves a copy of the cache per token. The reference's
``lax.scan`` over layers is a loop over ``layers``. Not ported yet
(ROADMAP.md): the ``moe``, ``encdec`` and ``vlm`` families and ``loss_fn``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import linear_rnn as R

SERVED_FAMILIES = ("dense", "hybrid", "ssm")
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


def _mlp_spec(cfg: ModelConfig, dt):
    d, f = cfg.d_model, cfg.d_ff
    return {"wi": _dense((d, f), dt), "wo": _dense((f, d), dt),
            "wg": _dense((d, f), dt)}


def _block_spec(cfg: ModelConfig, kind: str) -> dict:
    """One block's leaves: name -> (shape, dtype, init), or a dict of them
    for a sub-layer; the reference's ``_init_block`` leaf for leaf."""
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
    p["mlp"] = _mlp_spec(cfg, dt)
    return p


def _block_kind(cfg: ModelConfig) -> str:
    return {"dense": "dense", "hybrid": "hybrid", "ssm": "rwkv"}[cfg.family]


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
                 rnn_state=None, decode=False):
    """Returns (x, cache, new_rnn_state). Prefill (``decode`` False) starts
    the recurrences from the zero state; decode continues ``rnn_state``."""
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
    return x + L.mlp(p.mlp, h), cache, new_rnn


# ==================================================================== Model
class Model(nn.Module):
    """A served model of one config, on ``device`` (the CUDA card unless
    told otherwise; ``"meta"`` gives shapes without memory)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family not in SERVED_FAMILIES:
            raise NotImplementedError(
                f"the port serves the {SERVED_FAMILIES} families; "
                f"{cfg.family!r} ({cfg.name}) is still to port (ROADMAP.md, "
                f"port queue)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self._rules: dict[str, tuple] = {}
        dt = L.dtype_of(cfg)
        emb = {"tok": _dense((cfg.vocab, cfg.d_model), dt,
                             1.0 / math.sqrt(cfg.d_model))}
        if not cfg.tie_embeddings:
            emb["out"] = _dense((cfg.d_model, cfg.vocab), dt,
                                1.0 / math.sqrt(cfg.d_model))
        top = _Leaves({"embed": emb, "final_norm": _fill((cfg.d_model,), 1.0)},
                      self.device, self._rules, "")
        self.embed, self.final_norm = top.embed, top.final_norm
        kind = _block_kind(cfg)
        self.layers = nn.ModuleList(
            _Leaves(_block_spec(cfg, kind), self.device, self._rules,
                    f"layers.{i}.") for i in range(cfg.n_layers))

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

    # --------------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill_fn(self, batch: dict):
        """Forward over the prompt ``batch["tokens"]`` (b, s) with cache
        writes; returns (last-token logits (b, vocab) float32, state)."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        b, s = tokens.shape
        x = L.embed(self.embed, tokens)
        pos = torch.arange(s, device=self.device)[None].expand(b, s)
        caches, rnn = self._inner_state(b, self._cache_len(s), s)
        x = self._layers(x, pos, caches, rnn, decode=False)
        return self._logits(x[:, -1:]), {"kv": caches, "rnn": rnn}

    # ---------------------------------------------------------------- decode
    @torch.no_grad()
    def decode_fn(self, state: dict, tokens, length: int):
        """One token for every sequence: tokens (b, 1) at position
        ``length``. Updates ``state`` in place and returns (logits,
        state)."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        b = tokens.shape[0]
        x = L.embed(self.embed, tokens)
        pos = torch.full((b, 1), int(length), device=self.device)
        x = self._layers(x, pos, state["kv"], state["rnn"], decode=True)
        return self._logits(x), state

    def _layers(self, x, pos, caches, rnn, *, decode: bool):
        kind = _block_kind(self.cfg)
        for i, p in enumerate(self.layers):
            cache = None if caches is None else L.KVCache(
                caches.k[i], caches.v[i], caches.length[i])
            rnn_i = None if rnn is None else {k: v[i] for k, v in rnn.items()}
            x, _, new_rnn = _apply_block(p, x, self.cfg, kind, positions=pos,
                                         cache=cache, rnn_state=rnn_i,
                                         decode=decode)
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
        cfg = self.cfg
        n = cfg.n_layers if n is None else n
        shape = (n, b, cache_len, cfg.n_kv, cfg.head_dim)
        dt = L.cache_dtype(cfg)
        return L.KVCache(
            k=torch.zeros(shape, dtype=dt, device=self.device),
            v=torch.zeros(shape, dtype=dt, device=self.device),
            length=torch.zeros((n,), dtype=torch.int32, device=self.device))

    def _inner_state(self, b: int, cache_len: int, seq: int):
        cfg = self.cfg
        kind = _block_kind(cfg)
        n = cfg.n_layers
        caches, rnn = None, None
        if kind in ("dense", "hybrid"):
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
