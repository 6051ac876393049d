"""Llama-3.2-1B [hf:meta-llama/Llama-3.2-1B] - the paper's own eval model."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense", d_model=2048, num_layers=16,
    num_heads=32, num_kv_heads=8, head_dim=64, d_ff=8192, vocab_size=128256,
    rope_theta=500000.0, tie_embeddings=True,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, d_model=128, num_layers=4, num_heads=4, num_kv_heads=2,
    head_dim=32, d_ff=256, vocab_size=512)
