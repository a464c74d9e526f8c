"""qwen2-vl-72b [vlm] — M-RoPE backbone; stub patch-embedding frontend.
[arXiv:2409.12191; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv=8, d_ff=29568, vocab=152064,
    m_rope=True, rope_theta=1e6, use_bias=True,
)
