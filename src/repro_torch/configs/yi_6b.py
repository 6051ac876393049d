"""Yi-6B: llama-arch dense GQA [arXiv:2403.04652; hf]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", family="dense", d_model=4096, num_layers=32, num_heads=32,
    num_kv_heads=4, head_dim=128, d_ff=11008, vocab_size=64000,
    rope_theta=5e6, tie_embeddings=True,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, d_model=128, num_layers=4, num_heads=4, num_kv_heads=2,
    head_dim=32, d_ff=256, vocab_size=512)
