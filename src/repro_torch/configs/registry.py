"""Architecture registry: ``--arch <id>`` resolution + reduced smoke configs
(the port's copy of ``repro.configs.registry``)."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig

ARCHS = (
    "mixtral-8x22b",
    "moonshot-v1-16b-a3b",
    "codeqwen1.5-7b",
    "deepseek-7b",
    "smollm-135m",
    "starcoder2-3b",
    "hymba-1.5b",
    "qwen2-vl-72b",
    "whisper-large-v3",
    "rwkv6-7b",
)

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in ARCHS}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch]).CONFIG


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config: tiny layers/width/experts for CPU smoke tests."""
    cfg = get_config(arch)
    kw = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv=max(1, min(cfg.n_kv, 2)),
        d_ff=128,
        vocab=256,
        head_dim=16,
        attn_chunk_q=32,
        attn_chunk_kv=32,
        chunk_gla=16,
    )
    if cfg.n_experts:
        kw.update(n_experts=4, top_k=2)
    if cfg.window:
        kw.update(window=32)
    if cfg.encoder_layers:
        kw.update(encoder_layers=2, decoder_len=16)
    if cfg.ssm_state:
        kw.update(ssm_state=8)
    if cfg.moe_first_dense:
        kw.update(moe_first_dense=1)
    return dataclasses.replace(cfg, **kw)
