"""hymba-1.5b [hybrid] — parallel attention + mamba(SSD) heads, SWA. [arXiv:2411.13676]

Deviations noted in DESIGN.md: all layers sliding-window (the published mix of
global/local layers breaks scan homogeneity); meta-tokens omitted; the SSM half is
the scalar-decay SSD form.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv=5, d_ff=5504, vocab=32001,
    ssm_state=16, window=1024, rope_theta=1e4,
)
