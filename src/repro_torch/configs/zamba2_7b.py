"""Zamba2-7B: Mamba2 backbone + weight-shared attention block (every 6th
layer) with per-invocation LoRA [arXiv:2411.15242]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid", d_model=3584, num_layers=81,
    num_heads=32, num_kv_heads=32, head_dim=112, d_ff=14336,
    vocab_size=32000,
    pattern=("mamba", "mamba", "mamba", "mamba", "mamba", "mamba_shared"),
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=64,
    lora_rank=64, tie_embeddings=True,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, d_model=128, num_layers=6, num_heads=4, num_kv_heads=4,
    head_dim=32, d_ff=256, vocab_size=512, ssm_state=16, ssm_head_dim=16,
    ssm_chunk=32, lora_rank=8)
