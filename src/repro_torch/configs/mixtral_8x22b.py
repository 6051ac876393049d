"""Mixtral 8x22B: 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088; hf]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe", d_model=6144, num_layers=56,
    num_heads=48, num_kv_heads=8, head_dim=128, d_ff=16384, vocab_size=32768,
    pattern=("moe_local",), sliding_window=4096,
    num_experts=8, top_k=2, moe_d_ff=16384, rope_theta=1e6,
    tie_embeddings=False,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, d_model=128, num_layers=4, num_heads=4, num_kv_heads=2,
    head_dim=32, d_ff=256, moe_d_ff=256, vocab_size=512, num_experts=4,
    sliding_window=16)
