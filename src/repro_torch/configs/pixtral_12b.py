"""Pixtral-12B backbone: mistral-nemo decoder + stubbed pixtral-ViT patch
embeddings [hf:mistralai/Pixtral-12B-2409]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm", d_model=5120, num_layers=40,
    num_heads=32, num_kv_heads=8, head_dim=128, d_ff=14336,
    vocab_size=131072, rope_theta=1e6, vit_dim=1024, num_image_tokens=256,
    tie_embeddings=False,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, d_model=128, num_layers=4, num_heads=4, num_kv_heads=2,
    head_dim=32, d_ff=256, vocab_size=512, vit_dim=64, num_image_tokens=8)
