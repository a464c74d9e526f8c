"""smollm-135m [dense] — small llama arch, GQA kv=3. [hf:HuggingFaceTB/SmolLM-135M]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv=3, d_ff=1536, vocab=49152,
    rope_theta=1e4, tie_embeddings=True,
)
