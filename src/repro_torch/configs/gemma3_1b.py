"""Gemma-3 1B: 5:1 local:global, window 512, QK-norm, dual rope thetas
[hf:google/gemma-3-1b-pt]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense", d_model=1152, num_layers=26,
    num_heads=4, num_kv_heads=1, head_dim=256, d_ff=6912, vocab_size=262144,
    pattern=("local", "local", "local", "local", "local", "attn"),
    sliding_window=512, rope_theta=1e6, local_rope_theta=1e4, qk_norm=True,
    scale_embed=True, act="gelu", tie_embeddings=True,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, d_model=128, num_layers=8, num_heads=4, num_kv_heads=1,
    head_dim=32, d_ff=256, vocab_size=512, sliding_window=16)
