"""codeqwen1.5-7b [dense] — qwen1.5 arch (MHA: kv == heads). [hf:Qwen/CodeQwen1.5-7B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv=32, d_ff=13440, vocab=92416,
    rope_theta=1e6, use_bias=True,
)
