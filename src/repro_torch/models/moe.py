"""Mixture-of-Experts FFN, the counterpart of ``repro.models.moe``: top-k
routing in float32, capacity-bounded dispatch by a stable sort per batch
row, the experts as batched products, and the load-balancing auxiliary
loss.

The reference computes all of it outside any Pallas kernel, so the port
does too, in plain PyTorch. Where the reference sums the experts' outputs
with a sequential scatter-add (``.at[tok].add``, in slot order), the port
gathers each token's slots and adds them in the same order (its experts
ascending): a token sits in at most ``top_k`` slots, and a gather gives the
same sum on every call, where ``index_add_`` on the card sums in an order
that changes from run to run.

The ``moe.dispatch``, ``moe.experts`` and ``moe.combine`` profiler labels
name the three stages in a trace.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig

_F32 = torch.float32


def init_moe(cfg: ModelConfig, dt: torch.dtype) -> dict:
    """The leaves of ``repro.models.moe.init_moe``: name -> (shape, dtype,
    init rule), the router in float32."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    std = ("normal", 1.0 / math.sqrt(d))
    return {"router": ((d, e), _F32, std),
            "wi": ((e, d, f), dt, std), "wg": ((e, d, f), dt, std),
            "wo": ((e, f, d), dt, ("normal", 1.0 / math.sqrt(f)))}


def capacity(cfg: ModelConfig, s: int) -> int:
    """Slots per expert and batch row for ``s`` tokens: capacity_factor * s
    * top_k / n_experts, rounded up to a multiple of 128 from 128 on, else
    of 8; at most s * top_k, at least 1 (decode: min(8, top_k))."""
    k = cfg.top_k
    cap = max(int(cfg.capacity_factor * s * k / cfg.n_experts), 1)
    cap = (cap + 127) // 128 * 128 if cap >= 128 else (cap + 7) // 8 * 8
    return max(min(cap, s * k), 1)


class Routing(NamedTuple):
    tok_of_slot: torch.Tensor    # (b, e * cap) int64: a slot's token (0 if empty)
    gate_of_slot: torch.Tensor   # (b, e * cap) float32: its gate (0 if empty)
    slot: torch.Tensor           # (b, s, k) int64: each choice's slot, experts ascending
    kept: torch.Tensor           # (b, s, k) bool: the choice found room
    gate: torch.Tensor           # (b, s, k) float32: its renormalised gate
    cap: int


def route(p, x: torch.Tensor, cfg: ModelConfig):
    """Top-k routing of x (b, s, d) in float32: returns (the slot tables,
    the load-balancing loss)."""
    e, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(torch.einsum("bsd,de->bse", x.float(), p["router"]),
                          dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    # load-balancing aux loss (Switch/Mixtral form, global means)
    me = probs.mean(dim=(0, 1))
    ce = (F.one_hot(gate_idx, e).sum(dim=2) > 0).float().mean(dim=(0, 1))
    b, s = x.shape[:2]
    return (slot_tables(gate_idx.reshape(b, s * k),
                        gate_vals.reshape(b, s * k), cfg),
            e * torch.sum(me * ce))


def slot_tables(flat_expert: torch.Tensor, flat_gate: torch.Tensor,
                cfg: ModelConfig) -> Routing:
    """The dispatch of each batch row's s * k choices (token-major: choice
    j of token t at t * k + j): sorted by expert (stable, so tokens keep
    their order within an expert), the first ``cap`` of an expert kept."""
    e, k = cfg.n_experts, cfg.top_k
    b, n = flat_expert.shape
    s, dev = n // k, flat_expert.device
    cap = capacity(cfg, s)
    flat_expert = flat_expert.long()
    order = torch.argsort(flat_expert, dim=-1, stable=True)
    se = torch.gather(flat_expert, 1, order)
    pos = (torch.arange(n, device=dev)
           - torch.searchsorted(se, se, side="left"))
    pos_of_choice = torch.empty_like(pos).scatter_(1, order, pos)
    kept = pos_of_choice < cap
    slot = flat_expert * cap + pos_of_choice
    # an overflowing choice writes the extra last slot, which is cut off
    target = torch.where(kept, slot, e * cap)
    tok_of_slot = torch.zeros((b, e * cap + 1), dtype=torch.long,
                              device=dev).scatter_(
        1, target, torch.arange(n, device=dev).expand(b, n) // k)[:, :-1]
    gate_of_slot = torch.zeros((b, e * cap + 1), dtype=_F32,
                               device=dev).scatter_(
        1, target, flat_gate.float())[:, :-1]
    # each token's choices in slot order (its experts ascending)
    by_expert = torch.argsort(flat_expert.reshape(b, s, k), dim=-1)

    def pick(t):
        return torch.gather(t.reshape(b, s, k), 2, by_expert)

    return Routing(tok_of_slot, gate_of_slot, pick(slot), pick(kept),
                   pick(flat_gate.float()), cap)


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig):
    """x (b, s, d) -> (y (b, s, d) in x's dtype, aux float32 scalar)."""
    b, s, d = x.shape
    e = cfg.n_experts
    with record_function("moe.dispatch"):
        r, aux = route(p, x, cfg)
        xe = torch.gather(x, 1, r.tok_of_slot[..., None].expand(-1, -1, d))
        # an empty slot points at token 0: its gate of 0 masks it
        xe = (xe * (r.gate_of_slot > 0)[..., None].to(x.dtype)).reshape(
            b, e, r.cap, d)
    with record_function("moe.experts"):
        h = torch.einsum("becd,edf->becf", xe, p["wi"])
        g = torch.einsum("becd,edf->becf", xe, p["wg"])
        y = torch.einsum("becf,efd->becd", F.silu(g) * h, p["wo"])
    with record_function("moe.combine"):
        k = cfg.top_k
        idx = (r.slot * r.kept).reshape(b, s * k, 1).expand(-1, -1, d)
        ys = torch.gather(y.reshape(b, e * r.cap, d), 1, idx).reshape(
            b, s, k, d).float()
        ys = torch.where(r.kept[..., None], ys * r.gate[..., None], 0.0)
        out = torch.zeros((b, s, d), dtype=_F32, device=x.device)
        for j in range(k):      # slot order, as the reference's scatter-add
            out = out + ys[:, :, j]
    return out.to(x.dtype), aux
