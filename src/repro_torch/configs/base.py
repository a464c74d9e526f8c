"""Model, shape and training configuration dataclasses of the model zoo:
the port's copy of ``repro.configs.base`` (which imports no JAX), so that
the port imports nothing of the reference package."""
from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "hybrid", "ssm", "encdec", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_first_dense: int = 0         # leading dense layers (moonshot/deepseek style)
    capacity_factor: float = 1.25

    # attention
    window: int = 0                  # sliding-window size; 0 = full causal
    rope_theta: float = 1e4
    m_rope: bool = False             # qwen2-vl multimodal RoPE
    use_bias: bool = False           # starcoder2-style linear bias

    # SSM / hybrid / linear-attn
    ssm_state: int = 0               # mamba state width (hymba)
    rwkv: bool = False               # rwkv6 channel/time mix instead of attention

    # encoder-decoder (whisper)
    encoder_layers: int = 0          # >0 => enc-dec; n_layers counts decoder layers
    decoder_len: int = 448

    # numerics / perf knobs
    dtype: str = "bfloat16"
    remat: Literal["full", "none"] = "full"
    use_flash: bool = False          # read by neither package: the port's
                                     # model always calls its kernels
    attn_chunk_q: int = 2048
    attn_chunk_kv: int = 1024
    causal_scheme: Literal["rect", "tri"] = "rect"   # §Perf knob
    scan_layers: bool = True
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    chunk_gla: int = 64              # chunked gated-linear-attention block
    cache_headroom: int = 0          # extra KV slots beyond the prefill length
    kv_dtype: str = ""               # KV-cache dtype override ("float8_e4m3fn"
                                     # halves cache bytes; "" = activation dtype)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def sub_quadratic(self) -> bool:
        """Can this architecture decode 500k-token contexts? (DESIGN.md §6)"""
        return self.family in ("ssm", "hybrid") or self.window > 0

    @property
    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks), for roofline terms."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv * hd + self.n_heads * hd * d
        if self.rwkv:
            mix = 2 * d * d + d * self.n_heads * hd * 2   # r,k,v,w,g projections approx
            ffn = 2 * d * f
            block = mix + ffn
        elif self.n_experts:
            ffn_moe = self.n_experts * 3 * d * f + d * self.n_experts
            ffn_dense = 3 * d * f
            n_moe = self.n_layers - self.moe_first_dense
            block = attn + ffn_moe
            total = (n_moe * (attn + ffn_moe)
                     + self.moe_first_dense * (attn + ffn_dense) + 2 * v * d)
            return total
        else:
            ffn = 3 * d * f
            block = attn + ffn
        layers = self.n_layers + self.encoder_layers
        return layers * block + 2 * v * d

    @property
    def active_param_count(self) -> int:
        """Active params per token (= param_count for dense; routed subset for MoE)."""
        if not self.n_experts:
            return self.param_count
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv * hd + self.n_heads * hd * d
        ffn_act = self.top_k * 3 * d * f
        return self.n_layers * (attn + ffn_act) + 2 * v * d


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: Literal["train", "prefill", "decode"]


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """DESIGN.md §6: long_500k only for sub-quadratic archs; all else universal."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        names.append("long_500k")
    return names


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatches: int = 1            # gradient-accumulation steps
    compress_grads: bool = False     # int8 + error-feedback DCN compression
    opt_dtype: str = "float32"       # Adam moment dtype ("bfloat16" halves state)
    seed: int = 0
