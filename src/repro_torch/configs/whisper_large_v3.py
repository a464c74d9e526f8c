"""whisper-large-v3 [audio] — enc-dec backbone; conv frontend is a stub
(input_specs provides precomputed frame embeddings). [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, d_model=1280, n_heads=20, n_kv=20, d_ff=5120, vocab=51866,
    encoder_layers=32, decoder_len=448, use_bias=True,
)
