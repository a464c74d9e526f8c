"""starcoder2-3b [dense] — GQA kv=2 (assignment), RoPE, linear bias. [arXiv:2402.19173]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv=2, d_ff=12288, vocab=49152,
    rope_theta=1e5, use_bias=True,
)
