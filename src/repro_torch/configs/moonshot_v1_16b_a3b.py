"""moonshot-v1-16b-a3b (Moonlight) [moe] — 64 experts top-6, leading dense layer.

[hf:moonshotai/Moonlight-16B-A3B; hf]. Deviation noted in DESIGN.md: shared experts
are folded into the routed set; the published leading dense layer is kept.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv=16, d_ff=1408, vocab=163840,
    n_experts=64, top_k=6, moe_first_dense=1, rope_theta=5e4,
)
