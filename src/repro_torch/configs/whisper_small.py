"""Whisper-small backbone: 12L enc + 12L dec, layernorm/gelu, conv frontend
stubbed as precomputed frame embeddings [arXiv:2212.04356]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio", d_model=768, num_layers=12,
    num_heads=12, num_kv_heads=12, head_dim=64, d_ff=3072, vocab_size=51865,
    pattern=("dec",), encoder_layers=12, norm="layernorm", act="gelu",
    use_rope=False, tie_embeddings=True, norm_eps=1e-5,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, d_model=128, num_layers=2, encoder_layers=2, num_heads=4,
    num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512)
